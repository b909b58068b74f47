"""Host time of a fleet tick's read: the mean of the program's
``fleet.read`` timer (``hs.fleet.read``: the R poses and gates to the
host, which waits for the step on the device) over the run's untraced
ticks, warm-up included."""


def read(run):
    try:
        from hector_slam_tpu_torch import tracing
    except ImportError:   # a program without the spans
        return None
    _, timed, ns = tracing.timed("fleet.read")
    return ns / timed * 1e-6 if timed else None
