"""The moments kernel's share of its roofline: the least time the card
needs for the traced calls' moments (``roofline/formulas.py``, counted
from the inputs) over the summed time of ``interp_moments_kernel``'s
launches in the trace."""

from benchmark.reference import slam_ref
from benchmark.roofline import formulas


def read(run):
    trace, work = run.tracer.trace, run.info.get("work")
    if trace is None or not run.info.get("traced_calls") or not work:
        return None
    spent = trace.kernel_s("interp_moments_kernel")
    if spent <= 0:
        return None
    p = slam_ref.params(run.cell.config)
    least = 0.0
    for h, pts, mask, true in zip(work["hyps"], work["pts"], work["mask"],
                                  work["true"]):
        ops, bytes_, _, _ = formulas.match_work(p, h, true, pts, mask)
        least += formulas.least_s(ops, bytes_)
    return 100.0 * least / spent
