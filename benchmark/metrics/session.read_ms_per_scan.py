"""Host time the session's read of a scan's pose, covariance and gate
takes: the mean of the program's ``session.read`` timer (``hs.read``,
which waits for the card's queued work) over the run's untraced scans,
warm-up included."""


def read(run):
    try:
        from hector_slam_tpu_torch import tracing
    except ImportError:   # a program without the spans
        return None
    _, timed, ns = tracing.timed("session.read")
    return ns / timed * 1e-6 if timed else None
