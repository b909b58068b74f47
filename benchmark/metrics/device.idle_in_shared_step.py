"""The device's idle share while a shared-map fleet tick is due and not
yet answered, read as ``device.idle_in_step`` reads a fleet's: 1 -
device busy time / the time from each traced tick's due time (or the
end of the tick before it, if later) to all its poses on the host,
summed over the traced ticks."""

from benchmark.harness.spec import metric_reader


def read(run):
    return metric_reader("device.idle_in_step").read(run)
