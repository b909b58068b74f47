"""CUDA graphs the program captured since its import (``graphs.totals``):
a graph captured again after the cache dropped it counts again."""


def read(run):
    from hector_slam_tpu_torch.core import graphs
    n = graphs.totals()["captures"]
    return float(n) if n else None
