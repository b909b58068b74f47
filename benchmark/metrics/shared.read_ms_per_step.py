"""Host time of a shared-map fleet tick's read, read as
``fleet.read_ms_per_step`` reads a fleet's: the mean of the program's
``fleet.read`` timer (``hs.fleet.read``: the R poses and gates to the
host, which waits for the step on the device), which ``FleetSession``
keeps in either mode."""

from benchmark.harness.spec import metric_reader


def read(run):
    return metric_reader("fleet.read_ms_per_step").read(run)
