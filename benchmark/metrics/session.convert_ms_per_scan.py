"""Host time a scan's conversion takes in the session: the mean of the
program's ``session.convert`` timer (``hs.convert``: ranges to a scan on
the device) over the run's untraced scans, warm-up included."""


def read(run):
    try:
        from hector_slam_tpu_torch import tracing
    except ImportError:   # a program without the spans
        return None
    _, timed, ns = tracing.timed("session.convert")
    return ns / timed * 1e-6 if timed else None
