"""Host time of a fleet tick's conversion: the mean of the program's
``fleet.convert`` timer (``hs.fleet.convert``: the R robots' ranges to
one scan on the device) over the run's untraced ticks, warm-up
included."""


def read(run):
    try:
        from hector_slam_tpu_torch import tracing
    except ImportError:   # a program without the spans
        return None
    _, timed, ns = tracing.timed("fleet.convert")
    return ns / timed * 1e-6 if timed else None
