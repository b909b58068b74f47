"""The readings that a cell's limits are set from, each judged by the
harness's own comparison (``core.judged``) against the cell's limits:
the program's numbers on many seeds; with ``--control``, the
lower-precision control's (the reference in bfloat16 in the program's
place, judged as the program is); with ``--fault <kind>``, the
program's with that fault planted in its timed path
(``tools/faults.py``). All in one process, each seed a full run of the
cell's window at the cell's size.

    python3 benchmark/tools/calibrate.py --workload <cell> \
        --seeds 1,2,3 --seconds 20 [--control] [--fault half] \
        --out runs/c.jsonl

Prints and appends one JSON record a seed. The benchmark's own runs
never run the control or a fault.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark.run import prepare
    prepare()
    from benchmark.harness import core, spec, trace
    from benchmark.tools import faults
    import torch
    torch.set_num_threads(1)

    cell = spec.find_cell(args.workload)
    core.require_cards(cell.chips)
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    if args.fault:
        faults.plant(cell.name, args.fault)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = core.Run(cell, seed, args.seconds, trace.Tracer(False),
                       time.perf_counter())
        run.info["with_control"] = args.control
        driver.main(run)
        correct, checks = core.judged(run)
        rec = dict(workload=cell.name, seed=seed, fault=args.fault,
                   correct=correct, checks=checks, e2e=run.e2e,
                   off=run.info.get("off"))
        if args.control:
            rec["control_correct"], rec["control"] = core.judged(
                core.as_control(run))
        with open(out, "a") as f:
            f.write(json.dumps(dict(rec, notes=run.notes)) + "\n")
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
