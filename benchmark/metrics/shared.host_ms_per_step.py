"""Host time a shared-map fleet tick spends in ``shared_fleet_step_jit``'s
graph: the mean of the program's ``graph.host[shared_fleet_step_jit]``
timer (``hs.graph:shared_fleet_step_jit``: lookup, copy-in, the replay's
launch, outputs) over the run's untraced uses that captured nothing,
warm-up included."""


def read(run):
    try:
        from hector_slam_tpu_torch import tracing
    except ImportError:   # a program without the spans
        return None
    _, timed, ns = tracing.timed("graph.host[shared_fleet_step_jit]")
    return ns / timed * 1e-6 if timed else None
