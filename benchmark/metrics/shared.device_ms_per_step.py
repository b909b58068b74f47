"""Device time a shared-map fleet step takes, read as
``fleet.device_ms_per_step`` reads a fleet's: the union of device
activity in the traced piece of the window over the ticks traced."""

from benchmark.harness.spec import metric_reader


def read(run):
    return metric_reader("fleet.device_ms_per_step").read(run)
