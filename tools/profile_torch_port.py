"""Where the time goes in the PyTorch port's two main paths on one card.

    python3 tools/profile_torch_port.py

Builds the bench.py workload (a 1024^2 x 3-level map from 10 simulated
scans with known poses) and traces, with torch.profiler, (1) one batched
match of 4096 hypotheses through match_hypotheses_kernel and (2) 40
sequential slam_step calls on the corridor fixture. For each it prints
one JSON line: wall time under the profiler (which adds host overhead
per op), summed kernel time, the device idle share (1 - kernel time /
wall time), the kernel launches and the top kernels by device time.
Needs a CUDA device; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profile(fn, label: str, top: int = 8) -> None:
    from torch.profiler import ProfilerActivity, profile
    fn()                                   # warm up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an aten op's own row repeats its kernels' time
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    print(json.dumps({
        "profile": label, "wall_ms": wall_ms, "device_ms": dev_ms,
        "device_idle_share": 1.0 - dev_ms / wall_ms,
        "kernel_launches": sum(r[2] for r in rows),
        "top": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                for us, k, c in rows[:top]]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                    simulate_trajectory)
    cfg = ht.BENCH_CONFIG
    laser = ht.LaserModel()
    poses_true = corridor_trajectory(10, advance=0.12, weave=0.03)
    ranges = simulate_trajectory(World.corridor(length=18.0, width=3.0),
                                 poses_true, laser, range_noise_std=0.005)
    scans = [ht.scan_from_ranges(r, cfg.map.level_scale(0), laser,
                                 cfg.max_beams) for r in ranges]
    state = ht.init_state(cfg)
    for sc, p in zip(scans, poses_true):
        state, _ = ht.slam_step(state, sc, cfg,
                                pose_hint=torch.from_numpy(p).cuda(),
                                map_without_matching=True)
    hyp = torch.from_numpy((poses_true[-1] + np.random.default_rng(0).normal(
        0, 0.05, (4096, 3))).astype(np.float32)).cuda()
    _profile(lambda: ht.match_hypotheses_kernel(
        state.log_odds, hyp, scans[-1], cfg, quads=state.quads),
        "batched_match_4096")

    fx_ranges, fx_laser, _ = ht.load_log(os.path.join(
        REPO, "tests", "fixtures", "corridor_utm30lx.npz"))
    fx = ht.stack_scans([ht.scan_from_ranges(
        r, cfg.map.level_scale(0), fx_laser, cfg.max_beams)
        for r in fx_ranges[:40]])
    _profile(lambda: ht.run_log(ht.init_state(cfg), fx, cfg),
             "sequential_40_scans")
    return 0


if __name__ == "__main__":
    sys.exit(main())
