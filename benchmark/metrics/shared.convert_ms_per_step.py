"""Host time of a shared-map fleet tick's conversion, read as
``fleet.convert_ms_per_step`` reads a fleet's: the mean of the program's
``fleet.convert`` timer (``hs.fleet.convert``), which ``FleetSession``
keeps in either mode."""

from benchmark.harness.spec import metric_reader


def read(run):
    return metric_reader("fleet.convert_ms_per_step").read(run)
