"""Device time a fleet step takes: the union of device activity in the
traced piece of the window over the ticks traced."""


def read(run):
    trace, n = run.tracer.trace, run.info.get("traced_steps", 0)
    if trace is None or not n or not trace.device:
        return None
    return trace.busy_s() / n * 1e3
