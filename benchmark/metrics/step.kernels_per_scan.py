"""Device kernels a scan runs: the kernels in the traced piece of the
window over the scans traced (copies and fills not counted)."""


def read(run):
    trace, n = run.tracer.trace, run.info.get("traced_scans", 0)
    if trace is None or not n or not trace.kernels():
        return None
    return trace.kernels() / n
