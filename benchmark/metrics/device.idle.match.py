"""The device's idle share over the traced piece of the closed-loop
matching window: 1 - the union of device activity / the traced
window."""


def read(run):
    trace = run.tracer.trace
    if trace is None or not run.info.get("traced_calls") or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
