"""The map update's paint kernel's share of its roofline: the least time
the card needs for the bytes the traced launches of
``raster_paint_kernel`` move by themselves (``roofline/raster_paint.py``:
the scans' inputs read once, one byte a distinct cell stored, counted a
traced tick by the driver into ``raster_paint_bytes``; the grids' zero
fill is not counted, nor timed) over the summed time of those launches
in the trace. Read only where the trace holds one launch a counted
tick."""

from benchmark.roofline import formulas

KERNEL = "raster_paint_kernel"


def read(run):
    trace, ticks = run.tracer.trace, run.info.get("raster_paint_bytes")
    if trace is None or not ticks:
        return None
    launches = sum(1 for name, _, _, cat in trace.device
                   if cat == "kernel" and KERNEL in name)
    spent = trace.kernel_s(KERNEL)
    if launches != len(ticks) or spent <= 0:
        return None
    return 100.0 * formulas.least_s(0.0, float(sum(ticks))) / spent
