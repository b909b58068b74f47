"""The device's idle share while a fleet tick is due and not yet
answered: 1 - device busy time / the time from each traced tick's due
time (or the end of the tick before it, if later) to all its poses on
the host, summed over the traced ticks. The wait between ticks is left
out."""


def read(run):
    trace = run.tracer.trace
    late = run.info.get("traced_started_late_s")
    if trace is None or not late:
        return None
    calls = sorted(trace.spans_named("fleet.process_ranges"))
    if len(calls) != len(late):
        return None
    total = busy = 0.0
    prev_end = None
    for (ts, dur), lag in zip(calls, late):
        lo = ts - lag * 1e6
        if prev_end is not None:
            lo = max(lo, prev_end)
        hi = ts + dur
        prev_end = hi
        total += hi - lo
        busy += trace.busy_s(lo, hi) * 1e6
    return 100.0 * (1.0 - busy / total) if total > 0 else None
