"""Runs a cell several times, each run a process of its own, and keeps
every result line.

    python3 benchmark/tools/runs.py --workload <cell> --seeds 11,12,13 \
        --seconds 20 --trace 0 --out runs/<name>.jsonl

Each run appends one JSON record (workload, seed, trace, exit code, wall
seconds, the result line, the end of standard error) to ``--out`` and
prints a one-line summary. With ``--spread`` it ends with each metric's
median and spread (the interquartile range over the median, from
``statistics.quantiles(n=4)``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return float("nan")
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    values = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        cmd = [sys.executable, "benchmark/run.py", "--workload",
               args.workload, "--seed", str(seed), "--seconds",
               str(args.seconds), "--trace", str(args.trace)]
        try:
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=args.timeout)
            rc, stdout, stderr = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
            stdout = stdout if isinstance(stdout, str) else stdout.decode()
            stderr = stderr if isinstance(stderr, str) else stderr.decode()
        wall = time.perf_counter() - t
        lines = stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        rec = dict(workload=args.workload, seed=seed, trace=args.trace,
                   rc=rc, wall_s=wall, result=res, stderr=stderr[-6000:])
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        summary = {}
        if res:
            summary = {k: v["value"] for k, v in res["metrics"].items()}
            for k, v in summary.items():
                values.setdefault(k, []).append(v)
            summary["correct"] = res["correct"]
            summary["checks"] = {k: v["value"]
                                 for k, v in res["checks"].items()}
        print(json.dumps(dict(seed=seed, rc=rc, wall_s=round(wall, 1),
                              **summary)), flush=True)
        if rc != 0:
            print(stderr[-3000:], flush=True)
    if args.spread:
        for k, v in values.items():
            print(f"{k}: median {statistics.median(v)!r} spread "
                  f"{spread(v)!r} over {len(v)} runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
