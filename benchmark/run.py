"""The benchmark of hector_slam_tpu_torch (the PyTorch and CUDA port) on
NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the mix names the driver that sets up, runs the measured
window and judges the outputs against the plain reference. With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled piece of the
window. Without the cards the cell asks for, the run fails and prints no
result. The kernels build into the program's own build directory; every
other cache goes under ``benchmark/.cache``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHES = (("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
          ("CUDA_CACHE_PATH", "nv"))


def prepare() -> None:
    """Imports start at the checkout's root, and every cache directory
    is a fixed one inside the checkout."""
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
    sys.path.insert(0, str(ROOT))
    for var, sub in CACHES:
        os.environ[var] = str(BENCH / ".cache" / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare()
    from benchmark.harness import core, spec, trace

    cell = spec.find_cell(args.workload)
    try:
        core.require_cards(cell.chips)
    except core.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)   # one process, one host thread of work
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    run = core.Run(cell, args.seed, args.seconds,
                   trace.Tracer(bool(args.trace)), T_PROCESS)
    driver.main(run)
    bad = core.forbidden_loaded()
    if bad:
        print(f"benchmark: the run's process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    core.emit(core.result(run, cell.chips))
    return 0


if __name__ == "__main__":
    sys.exit(main())
