"""Host time a batched match spends in ``match_hypotheses_kernel_jit``'s
graph: the mean of the program's
``graph.host[match_hypotheses_kernel_jit]`` timer
(``hs.graph:match_hypotheses_kernel_jit``: lookup, copy-in, the replay's
launch, outputs) over the run's untraced calls that captured nothing."""


def read(run):
    try:
        from hector_slam_tpu_torch import tracing
    except ImportError:   # a program without the spans
        return None
    _, timed, ns = tracing.timed(
        "graph.host[match_hypotheses_kernel_jit]")
    return ns / timed * 1e-6 if timed else None
