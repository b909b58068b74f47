"""CUDA graphs a shared-map fleet run captured, read as
``graph.captures`` reads them (``graphs.totals``): one, the shared step's,
where every tick of the window replays it."""

from benchmark.harness.spec import metric_reader


def read(run):
    return metric_reader("graph.captures").read(run)
