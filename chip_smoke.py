#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hector_slam_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout, holds each kernel
against its plain PyTorch version at the main path's shapes, and drives
the main path through the entry points a user calls:
  1. device  — the card's name, count, power limit;
  2. build   — nvcc builds every kernel (registers and spills printed);
  3. kernel vs plain — interp_moments at the bench shapes (random
     1024^2, 512^2, 256^2 grids, B=4096 hypotheses, N=1152 beams with
     the tail masked, some beams beyond the map edge): moments within
     1e-5 of each hypothesis's largest |moment|, used counts exactly
     equal, two launches bit-identical;
  4. sequential SLAM — the 435-scan corridor fixture on BENCH_CONFIG,
     held against the committed JAX reference trajectory
     (tests/fixtures/corridor_jax_reference.npz): every gate equal, equal
     update counts, pose RMSE < 5 mm;
  5. batched matching — the bench.py workload: a map built with known
     poses, 4096 hypotheses (sigma 0.05) matched through
     match_hypotheses_kernel (14 kernel launches per call), a
     256-hypothesis subset held against the plain batched matcher;
  6. the kernels line: per kernel, its launches on the main path, its
     largest error against the plain version, its time, the plain
     version's time and the bound computed from this run's inputs.
Each phase prints one JSON line; any failure exits non-zero. The last
line is {"ok": true, "device": {...}}. Without a card, or without the
rest of the repository beside it, it prints no result and exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REL_TOL = 1e-5          # kernel vs plain, relative to max |moment| per hyp
RMSE_BUDGET_M = 0.005   # port vs JAX pose RMSE on the fixture
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per in-bounds valid query of interp_moments: transform 8,
# fractions 4, bilinear value 9, quirk gradients 10, residual 1, rotation
# derivative 9, nine moment products and their sums 18
OPS_PER_USED_QUERY = 59
OPS_PER_OTHER_QUERY = 8   # a valid beam outside the map: the transform


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a, b):
    """max |a-b| over the 9 moments of each hypothesis, divided by that
    hypothesis's largest |b| moment; returns (worst relative, worst abs)."""
    ma = torch.cat([a.hess.reshape(-1, 9), a.dtr], -1)
    mb = torch.cat([b.hess.reshape(-1, 9), b.dtr], -1)
    diff = (ma - mb).abs().max(-1).values
    scale = mb.abs().max(-1).values.clamp(min=1e-30)
    return float((diff / scale).max()), float(diff.max())


def kernel_bound_ms(quad, shape, poses_map, points, mask, used):
    """Least time the card could take for one interp_moments call on these
    inputs, as (bytes time, operations time) in ms: the bytes it must move
    (the distinct quad cells the valid in-bounds queries read, the poses,
    sin/cos, points, mask and the output, each once) over HBM bandwidth,
    and its f32 operations over the f32 peak. The bound is the larger."""
    from hector_slam_tpu_torch.core.interp import _cells
    sin_t = torch.sin(poses_map[:, 2:3])
    cos_t = torch.cos(poses_map[:, 2:3])
    px, py = points[:, 0], points[:, 1]
    tx = cos_t * px + (-sin_t * py + poses_map[:, 0:1])
    ty = sin_t * px + (cos_t * py + poses_map[:, 1:2])
    inb, xi, yi, _, _ = _cells(torch.stack([tx, ty], -1), shape)
    flat = (yi.to(torch.int64) * shape[1] + xi.to(torch.int64))[inb & mask]
    cells = int(torch.unique(flat).numel())
    b, n = poses_map.shape[0], points.shape[0]
    n_used = float(used.sum())
    n_valid = float(b) * float(mask.sum())
    bytes_ = cells * 16 + b * (12 + 8 + 40) + n * 9
    ops = (OPS_PER_USED_QUERY * n_used
           + OPS_PER_OTHER_QUERY * (n_valid - n_used))
    return bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    from hector_slam_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


def phase_kernel_vs_plain(dev):
    from hector_slam_tpu_torch.core.interp import quad_pack
    from hector_slam_tpu_torch.ops.interp_moments import (
        interp_moments, interp_moments_plain)
    rng = np.random.default_rng(1)
    b, n, n_valid = 4096, 1152, 1081
    worst_abs = 0.0
    rows = []
    for size in (1024, 512, 256):
        quad = quad_pack(torch.from_numpy(
            rng.random((size, size), dtype=np.float32)).to(dev))
        ang = np.linspace(-2.356, 2.356, n).astype(np.float32)
        rad = rng.uniform(0.02, 0.6, n).astype(np.float32) * size
        pts = torch.from_numpy(np.stack([rad * np.cos(ang), rad * np.sin(ang)],
                                        -1).astype(np.float32)).to(dev)
        mask = torch.from_numpy(np.arange(n) < n_valid).to(dev)
        poses = torch.from_numpy(np.c_[
            size / 2 + rng.normal(0, 2.0, (b, 2)),
            rng.normal(0, 0.05, b)].astype(np.float32)).to(dev)
        shape = (size, size)
        k1 = interp_moments(quad, shape, poses, pts, mask)
        k2 = interp_moments(quad, shape, poses, pts, mask)
        ref = interp_moments_plain(quad, shape, poses, pts, mask)
        torch.cuda.synchronize()
        rel, abs_ = rel_err(k1, ref)
        worst_abs = max(worst_abs, abs_)
        same = all(torch.equal(x, y) for x, y in zip(k1, k2))
        used_equal = torch.equal(k1.used, ref.used)
        rows.append(dict(size=size, max_rel_err=rel, max_abs_err=abs_,
                         used_equal=used_equal, repeat_bit_identical=same,
                         used_fraction=float(ref.used.sum()) / (b * n_valid)))
        if not (rel <= REL_TOL and used_equal and same):
            emit("kernel_vs_plain", ok=False, levels=rows)
            raise SystemExit(f"interp_moments disagrees with its plain "
                             f"version at {size}^2: {rows[-1]}")
    emit("kernel_vs_plain", ok=True, tolerance_rel=REL_TOL, levels=rows)
    return worst_abs


def phase_sequential(interp_moments):
    import hector_slam_tpu_torch as ht
    ref = np.load(ROOT / "tests" / "fixtures" / "corridor_jax_reference.npz")
    ranges, laser, _ = ht.load_log(
        str(ROOT / "tests" / "fixtures" / "corridor_utm30lx.npz"))
    cfg = ht.BENCH_CONFIG
    scans = ht.stack_scans([ht.scan_from_ranges(
        r, cfg.map.level_scale(0), laser, cfg.max_beams) for r in ranges])
    state = ht.init_state(cfg)
    torch.cuda.synchronize()
    interp_moments.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, poses, metrics = ht.run_log(state, scans, cfg)
    end.record()
    torch.cuda.synchronize()
    launches = interp_moments.launches
    ms = start.elapsed_time(end)
    poses = poses.cpu().numpy()
    gates = metrics.map_updated.cpu().numpy()
    rmse = float(np.sqrt(np.mean((poses[:, :2] - ref["poses"][:, :2]) ** 2)))
    yaw_rmse = float(np.sqrt(np.mean(
        (poses[:, 2] - ref["poses"][:, 2]) ** 2)))
    gate_agree = int((gates == ref["map_updated"]).sum())
    count = int(state.map_update_count)
    trunc = int(metrics.truncated_free_cells.sum())
    ok = (gate_agree == len(gates) and count == int(ref["map_update_count"])
          and rmse < RMSE_BUDGET_M and trunc == 0
          and np.isfinite(poses).all() and poses.shape == ref["poses"].shape)
    emit("sequential_slam", ok=ok, scans=len(gates), ms=ms,
         scans_per_s=len(gates) / (ms / 1e3), gate_agreement=gate_agree,
         map_update_count=count, jax_map_update_count=int(
             ref["map_update_count"]), pose_rmse_m=rmse,
         yaw_rmse_rad=yaw_rmse, max_pose_diff=float(
             np.abs(poses - ref["poses"]).max()), truncated_free_cells=trunc,
         kernel_launches=launches)
    if not ok:
        raise SystemExit("sequential SLAM disagrees with the JAX reference")


def phase_batched(dev, interp_moments):
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.core.matcher import level_points
    from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                    simulate_trajectory)
    from hector_slam_tpu_torch.ops.interp_moments import (
        _launch, interp_moments_plain, prepare)
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
                                pose_hint=torch.from_numpy(p).to(dev),
                                map_without_matching=True)
    b = 4096
    rng = np.random.default_rng(0)
    hyp = torch.from_numpy((poses_true[-1] + rng.normal(0, 0.05, (b, 3)))
                           .astype(np.float32)).to(dev)
    scan = scans[-1]

    def match():
        return ht.match_hypotheses_kernel(state.log_odds, hyp, scan, cfg,
                                          quads=state.quads)

    torch.cuda.synchronize()
    interp_moments.launches = 0
    result, diag = match()
    torch.cuda.synchronize()
    launches = interp_moments.launches
    steps = sum((cfg.match.iterations_finest if lvl == 0
                 else cfg.match.iterations_coarse) + 1
                for lvl in range(cfg.map.levels))
    pose = result.pose.cpu().numpy()
    ms_call = cuda_ms(match, reps=10)

    # a 256-hypothesis subset through the plain batched matcher (the
    # sequential matcher's torch ops, batched over hypotheses)
    sub = 256
    plain = ht.match_pyramid(state.log_odds, hyp[:sub], scan, cfg,
                             quads=state.quads).pose.cpu().numpy()
    diffs = np.abs(pose[:sub] - plain).max(-1)
    p50, p90, p99 = (float(np.percentile(diffs, q)) for q in (50, 90, 99))

    # the kernel at each level's inputs as the main path gives them (the
    # hypotheses entering the level's first GN step), beside its plain
    # version and its bound
    levels, worst_abs = [], 0.0
    level_in = hyp
    for lvl in range(cfg.map.levels - 1, -1, -1):
        shape = tuple(state.log_odds[lvl].shape)
        est = world_to_map_pose(level_in, cfg.map.top_left_offset,
                                cfg.map.level_scale(lvl)).contiguous()
        pts = level_points(scan.points, lvl).contiguous()
        args = (state.quads[lvl], shape, est, pts, scan.mask)
        k = interp_moments(*args)
        p = interp_moments_plain(*args)
        rel, abs_ = rel_err(k, p)
        worst_abs = max(worst_abs, abs_)
        t_bytes, t_ops = kernel_bound_ms(*args, p.used)
        bufs = prepare(*args)
        levels.append(dict(
            level=lvl, shape=list(shape),
            gn_steps=(cfg.match.iterations_finest if lvl == 0
                      else cfg.match.iterations_coarse) + 1,
            # the bare launch (device time), and the wrapper with its
            # checks, sin/cos, allocation and assembly (host-bound)
            kernel_ms=cuda_ms(lambda: _launch(
                *args[:3], *bufs[:2], *args[3:], bufs[2]), 50),
            wrapper_ms=cuda_ms(lambda: interp_moments(*args), 20),
            plain_ms=cuda_ms(lambda: interp_moments_plain(*args), 5),
            bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
            bound_ms=max(t_bytes, t_ops), max_rel_err=rel,
            max_abs_err=abs_, used_equal=bool(torch.equal(k.used, p.used))))
        level_in = ht.match_hypotheses_kernel(
            state.log_odds, level_in, scan, cfg, quads=state.quads,
            max_level=lvl, min_level=lvl)[0].pose
    ok = (launches == steps and pose.shape == (b, 3)
          and np.isfinite(pose).all() and np.isfinite(plain).all()
          and p90 < 2e-3 and p99 < 5e-2
          and all(lv["used_equal"] and lv["max_rel_err"] <= REL_TOL
                  for lv in levels))
    emit("batched_matching", ok=ok, hypotheses=b, kernel_launches=launches,
         expected_launches=steps, ms_per_call=ms_call,
         matches_per_s=b / (ms_call / 1e3),
         fast_path_fraction=float(diag.fast_path_fraction()),
         subset_vs_plain_p50=p50, subset_vs_plain_p90=p90,
         subset_vs_plain_p99=p99,
         subset_vs_plain_max=float(diffs.max()), levels=levels)
    if not ok:
        raise SystemExit("batched matching failed its checks")
    return launches, levels, worst_abs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "hector_slam_tpu_torch").is_dir():
        print("chip_smoke: the hector_slam_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    from hector_slam_tpu_torch.ops.interp_moments import interp_moments

    smi = phase_device()
    phase_build()
    abs_kvp = phase_kernel_vs_plain(dev)
    phase_sequential(interp_moments)
    launches, levels, abs_main = phase_batched(dev, interp_moments)

    # launch-weighted means over the main path's level mix (6+4+4 steps)
    total = sum(lv["gn_steps"] for lv in levels)

    def mean(key):
        return sum(lv[key] * lv["gn_steps"] for lv in levels) / total

    print(json.dumps({"kernels": [{
        "name": "interp_moments",
        "route": "cuda",
        "source": "hector_slam_tpu_torch/csrc/interp_moments.cu",
        "replaces": "hector_slam_tpu/ops/pallas_interp.py:337",
        "launches": launches,
        "max_abs_err": max(abs_kvp, abs_main),
        "ms": mean("kernel_ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": ("operations" if mean("bound_ops_ms")
                     >= mean("bound_bytes_ms") else "bytes"),
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
