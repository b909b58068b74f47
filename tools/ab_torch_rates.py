"""Sequential and batched rates of the PyTorch port in two checkouts, on
one card, in one call, run in the order A, B, B, A.

    python3 tools/ab_torch_rates.py BASE_DIR [CHANGE_DIR]

``CHANGE_DIR`` defaults to the checkout this script lives in. Every run is
a process of its own that imports ``hector_slam_tpu_torch`` from one
checkout (so the two never share a module) and prints one JSON line:

  - ``sequential``: the 435-scan corridor fixture
    (tests/fixtures/corridor_utm30lx.npz) through ``run_log`` on
    BENCH_CONFIG, after a 40-scan warm-up: scans/s on the host clock, and
    the device kernels and device time per scan by torch.profiler over 40
    scans;
  - ``batched_kernel``: the bench.py workload (a map from 10 simulated
    corridor scans with known poses, 4096 hypotheses, sigma 0.05) through
    ``match_hypotheses_kernel``: ms per call by CUDA events;
  - ``batched_plain``: 256 of those hypotheses through ``match_pyramid``,
    the torch-op matcher: ms per call, and under torch.profiler one
    call's kernels, their summed device time and the six longest.

Then it prints the card's name and power limit and one summary line with
each checkout's two readings side by side. Needs a CUDA device; it
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events_ms(fn, reps: int) -> float:
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernels(prof, with_rows=False):
    """(kernel count, summed device ms[, rows longest first]) of a
    torch.profiler trace's device kernels."""
    import torch
    rows = sorted(((getattr(ev, "self_device_time_total", 0.0), ev.key,
                    ev.count) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    out = (sum(r[2] for r in rows), sum(r[0] for r in rows) / 1e3)
    return out + (rows,) if with_rows else out


def measure(root: str) -> dict:
    """The three readings of the package in ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                    simulate_trajectory)
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        ht.__file__))) == os.path.abspath(root), ht.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ht.BENCH_CONFIG
    out = {"root": os.path.abspath(root)}

    ranges, laser, _ = ht.load_log(os.path.join(
        HERE, "tests", "fixtures", "corridor_utm30lx.npz"))
    scans = ht.stack_scans([ht.scan_from_ranges(
        r, cfg.map.level_scale(0), laser, cfg.max_beams) for r in ranges])
    head = ht.Scan(*(t[:40] for t in scans))
    ht.run_log(ht.init_state(cfg), head, cfg)          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ht.run_log(ht.init_state(cfg), head, cfg)
        torch.cuda.synchronize()
    kernels, device_ms = _kernels(prof)
    t0 = time.perf_counter()
    state, poses, _ = ht.run_log(ht.init_state(cfg), scans, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = scans.points.shape[0]
    out["sequential"] = dict(scans=n, seconds=seconds, scans_per_s=n / seconds,
                             kernels_per_scan=kernels / 40,
                             device_ms_per_scan=device_ms / 40,
                             map_updates=int(state.map_update_count),
                             final_pose=poses[-1].tolist())

    truth = corridor_trajectory(10, advance=0.12, weave=0.03)
    sim = simulate_trajectory(World.corridor(length=18.0, width=3.0), truth,
                              ht.LaserModel(), range_noise_std=0.005)
    sc = [ht.scan_from_ranges(r, cfg.map.level_scale(0), ht.LaserModel(),
                              cfg.max_beams) for r in sim]
    st = ht.init_state(cfg)
    for s, p in zip(sc, truth):
        st, _ = ht.slam_step(st, s, cfg, pose_hint=torch.from_numpy(p).cuda(),
                             map_without_matching=True)
    hyp = torch.from_numpy((truth[-1] + np.random.default_rng(0).normal(
        0, 0.05, (4096, 3))).astype(np.float32)).cuda()
    out["batched_kernel"] = dict(hypotheses=4096, ms=_events_ms(
        lambda: ht.match_hypotheses_kernel(st.log_odds, hyp, sc[-1], cfg,
                                           quads=st.quads), 10))

    def plain():
        return ht.match_pyramid(st.log_odds, hyp[:256], sc[-1], cfg,
                                quads=st.quads)

    out["batched_plain"] = dict(hypotheses=256, ms=_events_ms(plain, 5))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        plain()
        torch.cuda.synchronize()
    kernels, device_ms, rows = _kernels(prof, with_rows=True)
    out["batched_plain"].update(
        device_ms=device_ms, kernels=kernels,
        top=[[k[:60], us / 1e3, c] for us, k, c in rows[:6]])
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    base = os.path.abspath(sys.argv[1])
    change = os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else HERE)
    runs = []
    for label, root in (("base", base), ("change", change),
                        ("change", change), ("base", base)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", root], capture_output=True,
                              text=True, timeout=900, check=False)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["label"] = label
        runs.append(run)
        print(json.dumps(run), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({label: {
        "sequential_scans_per_s": [r["sequential"]["scans_per_s"]
                                   for r in runs if r["label"] == label],
        "kernels_per_scan": [r["sequential"]["kernels_per_scan"]
                             for r in runs if r["label"] == label],
        "device_ms_per_scan": [r["sequential"]["device_ms_per_scan"]
                               for r in runs if r["label"] == label],
        "batched_kernel_ms": [r["batched_kernel"]["ms"]
                              for r in runs if r["label"] == label],
        "batched_plain_ms": [r["batched_plain"]["ms"]
                             for r in runs if r["label"] == label],
        "batched_plain_device_ms": [r["batched_plain"]["device_ms"]
                                    for r in runs if r["label"] == label]}
        for label in ("base", "change")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
