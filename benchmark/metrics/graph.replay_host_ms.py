"""Host time a graph's replay takes to launch: the mean of the program's
``graph.replay_host`` timer (``hs.graph.replay``, the host side of
``CUDAGraph.replay``) over the run's untraced replays, each graph's first
left out."""


def read(run):
    try:
        from hector_slam_tpu_torch import tracing
    except ImportError:   # a program without the spans
        return None
    _, timed, ns = tracing.timed("graph.replay_host")
    return ns / timed * 1e-6 if timed else None
