"""The batched match's share of its roofline: the least time the card
needs for the traced calls' match work (``roofline/formulas.py``:
moments, solves and pose updates, counted from the inputs) over the
device time of those calls (the union of device activity)."""

from benchmark.reference import slam_ref
from benchmark.roofline import formulas


def read(run):
    trace, work = run.tracer.trace, run.info.get("work")
    if trace is None or not run.info.get("traced_calls") or not work:
        return None
    busy = trace.busy_s()
    if busy <= 0:
        return None
    p = slam_ref.params(run.cell.config)
    least = 0.0
    for h, pts, mask, true in zip(work["hyps"], work["pts"], work["mask"],
                                  work["true"]):
        _, _, ops, bytes_ = formulas.match_work(p, h, true, pts, mask)
        least += formulas.least_s(ops, bytes_)
    return 100.0 * least / busy
