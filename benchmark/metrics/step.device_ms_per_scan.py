"""Device time a scan takes: the union of device activity in the traced
piece of the window over the scans traced."""


def read(run):
    trace, n = run.tracer.trace, run.info.get("traced_scans", 0)
    if trace is None or not n or not trace.device:
        return None
    return trace.busy_s() / n * 1e3
