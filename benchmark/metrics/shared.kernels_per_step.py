"""Device kernels a shared-map fleet tick runs: the kernels in the traced
piece of the window over the ticks traced (copies and fills not
counted)."""


def read(run):
    trace, n = run.tracer.trace, run.info.get("traced_steps", 0)
    if trace is None or not n or not trace.kernels():
        return None
    return trace.kernels() / n
