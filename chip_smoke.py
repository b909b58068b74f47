#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hector_slam_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout, holds each kernel
against its plain PyTorch version at the main path's shapes, and drives
the main path through the entry points a user calls:
  1. device  — the card's name, count, power limit;
  2. build   — nvcc builds every kernel, all at once (registers and spills
     printed; no kernel may spill), and matmul_stationary's SASS
     (cuobjdump) must hold wgmma's HGMMA and no mma.sync HMMA;
  3. kernel vs plain — interp_moments at the bench shapes (random
     1024^2, 512^2, 256^2 grids, B=4096 hypotheses, N=1152 beams with
     the tail masked, some beams beyond the map edge): moments within
     1e-5 of each hypothesis's largest |moment|, used counts exactly
     equal, two launches bit-identical;
  4. sequential SLAM — the 435-scan corridor fixture on BENCH_CONFIG,
     held against the committed JAX reference trajectory
     (tests/fixtures/corridor_jax_reference.npz): every gate equal, equal
     update counts, pose RMSE < 5 mm; one paint launch per gated update
     (its six cell sets in one table);
  5. batched matching — the bench.py workload: a map built with known
     poses, 4096 hypotheses (sigma 0.05) matched through
     match_hypotheses_kernel (14 kernel launches per call), a
     256-hypothesis subset held against the plain batched matcher;
  6. fleet — fleet_step with 64 robots, a BENCH_CONFIG pyramid each, every
     robot on its own simulated corridor trajectory, 25 steps: robots 0,
     21, 42 and 63 replayed alone through slam_step must agree bit for bit
     (gates, poses, every level's map); steps/s over steps 1-24 (step 0,
     from empty maps, is an untimed warm-up); one paint launch per update;
  7. shared fleet — shared_fleet_step with 64 robots in one BENCH_CONFIG
     pyramid, replaying the committed JAX reference's 16 steps
     (tests/fixtures/shared_fleet_jax_reference.npz, written by
     tools/make_torch_fleet_reference.py): gates equal for every robot
     and step, equal update counts, pose RMSE < 1e-4 m, each level's
     counts of cells > 0 and < 0 equal; steps/s over steps 1-15; one
     paint launch per update;
  8. paint vs plain — paint_cell_sets at the probe's own workload (1024^2,
     65,536 random cells) and at one update of each of the three
     map-update paths above (its six cell sets): grids exactly equal to
     the plain version's, two launches bit-identical, and the update's
     time as one call (one fill, one launch) and as six one-set calls,
     beside the plain version's, index_put_'s and the bytes bound;
  9. probes — the cost probes of tools/probe_pallas.py and
     tools/probe_mosaic_store.py at their own shapes, driven through
     hector_slam_tpu_torch.probes (take_along over 64 [8,128] tiles on both
     axes and on the four one-tile operands, matmul_stationary
     [8192,128]x[128,128] bf16, dyn_slice in its three modes on 1024^2,
     1024^2 painted per cell and per run): launch counts equal to the
     calls the probes issued; then each workload at its low and its high
     rep count, kernel vs plain: exactly equal (take_along, dyn_slice,
     paint_runs, paint_cells) or within MM_ULPS bf16 ulps
     (matmul_stationary, also at MM_DENORMAL_REPS, where every value of
     its chain is denormal), two launches bit-identical; the plain
     version's time at the low rep count, the library calls' (replayed
     from one CUDA graph), the bound and, for the two chain probes
     take_along and dyn_slice, the chain floor (reps x the dependent
     latency of one rep / the SM clock nvidia-smi reads on the busy card)
     at the high one; matmul_stationary's ns a rep over normal values and
     over denormal ones; take_along on lines longer than 256 (LONG_LINES,
     the kernel's block path), timed and held exactly to its plain
     version; then a paint_runs_split line (probes.store_split: the
     kernel's launch and grid barrier alone, + its fill, + its runs, and
     a torch.zeros fill alone);
 10. the kernels line: per kernel, its launches on the main path (each
     path, the probes included, is driven with the counts set to 0 just
     before it and read just after), its largest error against the plain
     version, its time, the plain version's and the library call's time,
     and the bound computed from this run's inputs (and the chain floor
     for take_along and dyn_slice).
Kernel, plain-version and library times are device times: the calls are
queued behind a device sleep (probes.time_ms), and ``host_in`` names any
time that still includes the host's (the function synchronises, or its
launches outran the queue). Only the end-to-end rates and the moments
wrapper's time are taken with the host feeding the device.
Each phase prints one JSON line; any failure exits non-zero. The last
line is {"ok": true, "device": {...}}. Without a card, or without the
rest of the repository beside it, it prints no result and exits 2.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REL_TOL = 1e-5          # kernel vs plain, relative to max |moment| per hyp
RMSE_BUDGET_M = 0.005   # port vs JAX pose RMSE, 435-scan sequential replay
SHARED_RMSE_M = 1e-4    # port vs JAX pose RMSE, shared fleet (see its tests)
FLEET_ROBOTS = 64       # BASELINE config 5: 64 parallel trajectories
FLEET_STEPS = 25        # one untimed warm-up step, then 24 timed
FLEET_CHECKED = (0, 21, 42, 63)   # replayed alone through slam_step
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s
# and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
OPS_PER_S = {"f32": F32_OPS_PER_S, "bf16": BF16_TENSOR_OPS_PER_S}
MM_ULPS = 2   # matmul_stationary vs plain, bf16 ulps (tests/test_torch_cuda.py)
# a rep count where every value of the matmul probe's chain is denormal and
# 3-6 smallest-denormal steps above 0 (tests/test_torch_cuda.py), and one
# just before the chain leaves the normal range, for a per-rep time over
# normal values only
MM_DENORMAL_REPS = 195
MM_NORMAL_REPS = 192
# take_along lines longer than a warp's 256 (the kernel's block path),
# kernel vs plain at the probes' rep counts: (name, shape, axis, tile_rows)
LONG_LINES = (("take_along (8,1024) ax1", (8, 1024), 1, None),
              ("take_along 2x(1024,8) ax0", (2048, 8), 0, 1024))
# f32 operations per in-bounds valid query of interp_moments, counted from
# the arithmetic the function needs (products reused, an FMA as 2):
#   transform (4 products, 4 sums)                              8
#   fractions fx, fy and 1-fx, 1-fy                             4
#   bilinear value: P10-P00, P11-P01, two x lerps, y lerp       9
#   quirk gradients, sharing the value's two differences:
#     gx = (P10-P00)*(1-fx) + (P11-P01)*fx                      3
#     gy = (P01-P00)*(1-fy) + (P11-P10)*fy                      5
#   residual 1-M                                                1
#   rotation derivative from the transform's products: two
#     sums, then dxr*gx + dyr*gy (3)                            5
#   nine moments, one FMA each                                 18
OPS_PER_USED_QUERY = 53
OPS_PER_OTHER_QUERY = 8   # a valid beam outside the map: the transform
# Dependent-issue latencies, in SM cycles, of the probe kernels' loop-
# carried chains: the Volta microbenchmark figures (Jia et al., "Dissecting
# the NVIDIA Volta GPU Architecture via Microbenchmarking", 2018: 4 for an
# f32 add or multiply, 19 for a shared-memory load), taken as a lower bound
# for Hopper; not measured on the card.
F32_LATENCY_CYCLES = 4
SHARED_LOAD_LATENCY_CYCLES = 19
CHAIN_CYCLES_PER_REP = {
    # tile 0's previous accumulator from shared memory, times 1e-30, plus
    # p, plus the element's own accumulator
    "take_along": SHARED_LOAD_LATENCY_CYCLES + 3 * F32_LATENCY_CYCLES,
    # one add to the element's accumulator
    "dyn_slice": F32_LATENCY_CYCLES}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def reset_counts(kernels) -> None:
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0


def read_counts(kernels) -> dict:
    torch.cuda.synchronize()
    return {name: k.launches for name, k in kernels.items()}


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` over ``reps`` calls, by CUDA events, after one
    warm-up call, with the host feeding the device: the time a caller
    sees, host launches included."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_times(**timed) -> dict:
    """``{name: (fn, calls)}`` -> ``{name: ms}`` by ``probes.time_ms`` (the
    calls queued behind a device sleep), plus ``host_in``: the names
    whose time still includes the host's (``fn`` synchronises, or its
    launches outran the queue)."""
    from hector_slam_tpu_torch.probes import time_ms
    out, host_in = {}, []
    for name, (fn, calls) in timed.items():
        out[name], device_only = time_ms(fn, calls)
        if not device_only:
            host_in.append(name)
    return dict(out, host_in=host_in)


def run_steps(step, state, scans):
    """Runs ``step(state, scans[t])`` over every step. Step 0 starts from
    empty maps (first use of the state's memory, every gate fires) and is
    an untimed warm-up; the rest are timed on the host clock up to the
    last step's completion. Returns (state, poses, metrics, seconds)."""
    poses, metrics, t0 = [], [], None
    for t, sc in enumerate(scans):
        state, m = step(state, sc)
        poses.append(state.pose)
        metrics.append(m)
        if t == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    return state, poses, metrics, time.perf_counter() - t0


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


def sass_counts(name: str) -> dict:
    """Tensor-core instructions in a built kernel library's SASS
    (``cuobjdump -sass``): wgmma's HGMMA and mma.sync's HMMA."""
    from hector_slam_tpu_torch.ops import cuda_build
    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(cuda_build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "HMMA")}


def phase_build():
    """Builds every kernel; matmul_stationary must run on wgmma (HGMMA in
    its SASS, no HMMA) and no kernel may spill."""
    from hector_slam_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "wgmma" in ln]
             for name, log in logs.items()}
    spills = {name: sum(int(n) for ln in lines for n in re.findall(
        r"(\d+) bytes spill", ln)) for name, lines in ptxas.items()}
    mm_sass = sass_counts("matmul_stationary")
    ok = (mm_sass["HGMMA"] > 0 and mm_sass["HMMA"] == 0
          and not any(spills.values()))
    emit("build", ok=ok, seconds=time.perf_counter() - t0,
         matmul_stationary_sass=mm_sass, spill_bytes=spills, ptxas=ptxas)
    if not ok:
        raise SystemExit("a kernel spills, or matmul_stationary does not "
                         "run on wgmma")


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


def phase_sequential(kernels):
    import hector_slam_tpu_torch as ht
    ref = np.load(ROOT / "tests" / "fixtures" / "corridor_jax_reference.npz")
    ranges, laser, _ = ht.load_log(
        str(ROOT / "tests" / "fixtures" / "corridor_utm30lx.npz"))
    cfg = ht.BENCH_CONFIG
    scans = ht.stack_scans([ht.scan_from_ranges(
        r, cfg.map.level_scale(0), laser, cfg.max_beams) for r in ranges])
    state = ht.init_state(cfg)
    reset_counts(kernels)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, poses, metrics = ht.run_log(state, scans, cfg)
    end.record()
    launches = read_counts(kernels)
    ms = start.elapsed_time(end)
    poses = poses.cpu().numpy()
    gates = metrics.map_updated.cpu().numpy()
    rmse = float(np.sqrt(np.mean((poses[:, :2] - ref["poses"][:, :2]) ** 2)))
    yaw_rmse = float(np.sqrt(np.mean(
        (poses[:, 2] - ref["poses"][:, 2]) ** 2)))
    gate_agree = int((gates == ref["map_updated"]).sum())
    count = int(state.map_update_count)
    trunc = int(metrics.truncated_free_cells.sum())
    paints = count   # one paint launch per gated update
    ok = (gate_agree == len(gates) and count == int(ref["map_update_count"])
          and rmse < RMSE_BUDGET_M and trunc == 0
          and np.isfinite(poses).all() and poses.shape == ref["poses"].shape
          and launches["paint_cells"] == paints)
    emit("sequential_slam", ok=ok, scans=len(gates), ms=ms,
         scans_per_s=len(gates) / (ms / 1e3), gate_agreement=gate_agree,
         map_update_count=count, jax_map_update_count=int(
             ref["map_update_count"]), pose_rmse_m=rmse,
         yaw_rmse_rad=yaw_rmse, max_pose_diff=float(
             np.abs(poses - ref["poses"]).max()), truncated_free_cells=trunc,
         kernel_launches=launches, expected_paint_launches=paints)
    if not ok:
        raise SystemExit("sequential SLAM disagrees with the JAX reference")
    # one gated update's paint inputs: a mid-log scan at its matched pose
    gated = np.flatnonzero(gates)
    t = int(gated[len(gated) // 2])
    return launches, (torch.from_numpy(poses[t]).to(scans.points.device),
                      ht.Scan(scans.points[t], scans.origo[t],
                              scans.mask[t]))


def phase_batched(dev, kernels):
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.core.matcher import level_points
    from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                    simulate_trajectory)
    from hector_slam_tpu_torch.ops.interp_moments import (
        _launch, interp_moments, interp_moments_plain, prepare)
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

    reset_counts(kernels)
    result, diag = match()
    launches = read_counts(kernels)
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
            # the bare launch and the plain version (device times), and
            # the wrapper with its checks, sin/cos, allocation and
            # assembly as a caller sees it (host-bound)
            **device_times(
                kernel_ms=(lambda: _launch(
                    *args[:3], *bufs[:2], *args[3:], bufs[2]), 50),
                plain_ms=(lambda: interp_moments_plain(*args), 5)),
            wrapper_ms=cuda_ms(lambda: interp_moments(*args), 20),
            bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
            bound_ms=max(t_bytes, t_ops), max_rel_err=rel,
            max_abs_err=abs_, used_equal=bool(torch.equal(k.used, p.used))))
        level_in = ht.match_hypotheses_kernel(
            state.log_odds, level_in, scan, cfg, quads=state.quads,
            max_level=lvl, min_level=lvl)[0].pose
    ok = (launches["interp_moments"] == steps and pose.shape == (b, 3)
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


def fleet_ranges():
    """Ranges f32[T, R, 1081] of FLEET_ROBOTS robots, each on its own
    corridor trajectory (start 0-6.75 m along the corridor, 0.05-0.12 m
    per scan, its own noise seed), and each robot's true poses
    f32[T, R, 3]."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                    simulate_trajectory)
    world = World.corridor(length=18.0, width=3.0)
    ranges, truth = [], []
    for r in range(FLEET_ROBOTS):
        advance = 0.05 + 0.07 * ((r * 37) % FLEET_ROBOTS) / (FLEET_ROBOTS - 1)
        poses = corridor_trajectory(FLEET_STEPS, advance=advance, weave=0.03)
        poses[:, 0] += 0.45 * (r % 16)
        truth.append(poses)
        ranges.append(simulate_trajectory(world, poses, ht.LaserModel(),
                                          range_noise_std=0.005,
                                          seed=100 + r))
    return np.stack(ranges, 1), np.stack(truth, 1)


def relative_pose(start, pose):
    """pose in the frame of start (both [..., 3], world)."""
    c, s = np.cos(start[..., 2]), np.sin(start[..., 2])
    dx, dy = pose[..., 0] - start[..., 0], pose[..., 1] - start[..., 1]
    return np.stack([c * dx + s * dy, -s * dx + c * dy,
                     pose[..., 2] - start[..., 2]], -1)


def phase_fleet(kernels):
    import hector_slam_tpu_torch as ht
    cfg = ht.BENCH_CONFIG
    laser = ht.LaserModel()
    ranges, truth = fleet_ranges()

    def scans_at(t):
        return ht.stack_scans([ht.scan_from_ranges(
            rg, cfg.map.level_scale(0), laser, cfg.max_beams)
            for rg in ranges[t]])

    scans = [scans_at(t) for t in range(FLEET_STEPS)]
    fleet = ht.init_fleet(cfg, FLEET_ROBOTS)
    reset_counts(kernels)
    fleet, poses, metrics, seconds = run_steps(
        lambda st, sc: ht.fleet_step(st, sc, cfg), fleet, scans)
    launches = read_counts(kernels)
    first = (poses[0], scans[0])   # the first update, every robot gated
    timed = FLEET_STEPS - 1
    poses = torch.stack(poses).cpu().numpy()
    gates = torch.stack([m.map_updated for m in metrics]).cpu().numpy()
    updates = int(gates.any(1).sum())
    paints = updates   # one paint launch per update of the whole fleet

    # each checked robot alone through slam_step, on the card
    solo = {}
    for r in FLEET_CHECKED:
        st = ht.init_state(cfg)
        sp, sg = [], []
        for t in range(FLEET_STEPS):
            st, sm = ht.slam_step(st, ht.Scan(scans[t].points[r],
                                              scans[t].origo[r],
                                              scans[t].mask[r]), cfg)
            sp.append(st.pose)
            sg.append(sm.map_updated)
        solo[r] = dict(
            gates_equal=bool((torch.stack(sg).cpu().numpy()
                              == gates[:, r]).all()),
            max_pose_diff_m=float(np.abs(torch.stack(sp).cpu().numpy()
                                         - poses[:, r]).max()),
            maps_bit_equal=all(torch.equal(a[r], b) for a, b in
                               zip(fleet.log_odds, st.log_odds)))
    # SLAM poses live in each robot's start frame: compare displacements
    err = np.linalg.norm(relative_pose(truth[0], truth)[..., :2]
                         - poses[..., :2], axis=-1)
    ok = (np.isfinite(poses).all() and poses.shape == (
        FLEET_STEPS, FLEET_ROBOTS, 3) and gates[0].all()
        and launches["interp_moments"] == 0
        and launches["paint_cells"] == paints and launches["paint_cells"] > 0
        and float(np.percentile(err, 90)) < 0.05
        and all(v["gates_equal"] and v["max_pose_diff_m"] <= 1e-6
                and v["maps_bit_equal"] for v in solo.values()))
    emit("fleet", ok=ok, robots=FLEET_ROBOTS, steps=FLEET_STEPS,
         warmup_steps=1, timed_steps=timed, window_s=seconds,
         steps_per_s=timed / seconds,
         robot_scans_per_s=timed * FLEET_ROBOTS / seconds,
         gates_per_step=gates.sum(1).tolist(), map_updates=updates,
         kernel_launches=launches, expected_paint_launches=paints,
         paint_launches_per_step=launches["paint_cells"] / FLEET_STEPS,
         truncated_free_cells=int(sum(m.truncated_free_cells.sum()
                                      for m in metrics)),
         displacement_err_p90_m=float(np.percentile(err, 90)),
         displacement_err_max_m=float(err.max()),
         solo_replays={str(k): v for k, v in solo.items()})
    if not ok:
        raise SystemExit("the fleet failed its checks")
    return launches, first


def phase_shared_fleet(kernels):
    import hector_slam_tpu_torch as ht
    ref = np.load(ROOT / "tests" / "fixtures"
                  / "shared_fleet_jax_reference.npz")
    if str(ref["config"]) != "BENCH_CONFIG":
        raise SystemExit(f"the fleet reference is for {ref['config']}")
    cfg = ht.BENCH_CONFIG
    laser = ht.LaserModel()
    r, steps = int(ref["robots"]), int(ref["steps"])
    scans = [ht.stack_scans([ht.scan_from_ranges(
        rg, cfg.map.level_scale(0), laser, cfg.max_beams)
        for rg in ref["ranges"][t]]) for t in range(steps)]
    state = ht.init_shared_fleet(cfg, r, start_poses=ref["start_poses"])
    reset_counts(kernels)
    state, poses, metrics, seconds = run_steps(
        lambda st, sc: ht.shared_fleet_step(st, sc, cfg), state, scans)
    launches = read_counts(kernels)
    first = (poses[0], scans[0])   # the first update, every robot gated
    timed = steps - 1
    poses = torch.stack(poses).cpu().numpy()
    gates = torch.stack([m.map_updated for m in metrics]).cpu().numpy()
    trunc = [m.truncated_free_cells for m in metrics]
    occ = [int((lo > 0).sum()) for lo in state.log_odds]
    free = [int((lo < 0).sum()) for lo in state.log_odds]
    rmse = float(np.sqrt(np.mean((poses[..., :2]
                                  - ref["poses"][..., :2]) ** 2)))
    count = int(state.map_update_count)
    paints = count   # one paint launch per update of the shared map
    ok = (bool((gates == ref["map_updated"]).all())
          and count == int(ref["map_update_count"]) and rmse < SHARED_RMSE_M
          and occ == ref["occupied_cells"].tolist()
          and free == ref["free_cells"].tolist()
          and torch.stack(trunc).cpu().numpy().tolist()
          == ref["truncated_free_cells"].tolist()
          and np.isfinite(poses).all()
          and launches["paint_cells"] == paints and paints > 0)
    emit("shared_fleet", ok=ok, robots=r, steps=steps, warmup_steps=1,
         timed_steps=timed, window_s=seconds, steps_per_s=timed / seconds,
         robot_scans_per_s=timed * r / seconds,
         gate_agreement=int((gates == ref["map_updated"]).sum()),
         gates=int(gates.size), gates_per_step=gates.sum(1).tolist(),
         map_update_count=count,
         jax_map_update_count=int(ref["map_update_count"]),
         pose_rmse_m=rmse, max_pose_diff=float(
             np.abs(poses - ref["poses"]).max()),
         occupied_cells=occ, jax_occupied_cells=ref["occupied_cells"].tolist(),
         free_cells=free, jax_free_cells=ref["free_cells"].tolist(),
         kernel_launches=launches, expected_paint_launches=paints)
    if not ok:
        raise SystemExit("the shared fleet disagrees with the JAX reference")
    return launches, first


def paint_index_sets(cfg, poses, scan, layout):
    """(names, indices i32, num_cells) of the six cell sets one map update
    paints at these poses: one scan (``single``), R scans into per-robot
    grids (``per_robot``) or into one shared grid (``shared``)."""
    from hector_slam_tpu_torch.core.mapping import cell_indices
    from hector_slam_tpu_torch.core.matcher import level_points
    names, flats, sizes = [], [], []
    for level in range(cfg.map.levels):
        sx, sy = cfg.map.level_size(level)
        free, occ, n, _ = cell_indices(
            (sy, sx), poses, level_points(scan.points, level),
            level_points(scan.origo, level), scan.mask,
            cfg.map.top_left_offset, cfg.map.level_scale(level),
            cfg.level_max_ray_cells(level), layout == "per_robot")
        for kind, flat in (("free", free), ("occupied", occ)):
            names.append(f"L{level} {kind}")
            flats.append(flat.reshape(-1).contiguous())
            sizes.append(n)
    return names, flats, sizes


def phase_paint(dev, inputs):
    """``inputs``: {path: (layout, poses, scan)} of one update per path.
    Returns (rows, mismatched cells)."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.ops.paint_cells import (
        _offsets, paint_cell_sets, paint_cell_sets_plain, paint_cells)
    cfg = ht.BENCH_CONFIG
    rng = np.random.default_rng(2)
    side = 1024   # the probe's own workload (tools/probe_mosaic_store.py)
    ys = rng.integers(0, side, 65536)
    xs = rng.integers(0, side, 65536)
    updates = [("probe 1024^2 x 65536", None, ["probe"], [torch.from_numpy(
        (ys * side + xs).astype(np.int32)).to(dev)], [side * side])]
    for path, (layout, poses, scan) in inputs.items():
        updates.append((f"{path} update", path,
                        *paint_index_sets(cfg, poses, scan, layout)))
    rows, mismatched = [], 0
    true = torch.ones((), dtype=torch.bool, device=dev)
    for name, path, names, flats, sizes in updates:
        k1 = paint_cell_sets(flats, sizes)
        k2 = paint_cell_sets(flats, sizes)
        plain = paint_cell_sets_plain(flats, sizes)
        bad = [int((a != b).sum()) for a, b in zip(k1, plain)]
        mismatched += sum(bad)
        total = _offsets(sizes)[-1]
        idx = [f.to(torch.int64) for f in flats]
        slots = [torch.zeros(n + 1, dtype=torch.bool, device=dev)
                 for n in sizes]
        # every index read once, every grid written once
        bytes_ = sum(4 * f.numel() + n for f, n in zip(flats, sizes))

        def per_set():
            for f, n in zip(flats, sizes):
                paint_cells(f, n)

        def library():
            # per set, one index_put_ into a zeroed grid with a sentinel
            # slot (the map update's indices lie in [0, num_cells])
            for i, n in zip(idx, sizes):
                torch.zeros(n + 1, dtype=torch.bool, device=dev).index_put_(
                    (i,), true)

        def library_into_zeroed():
            for i, sl in zip(idx, slots):
                sl.index_put_((i,), true)

        times = device_times(
            # the update as one call (one zero fill + one launch), as one
            # call per set (a fill + a launch each), the zero fill alone,
            # the plain version, and index_put_ per set with and without
            # its fill
            ms=(lambda: paint_cell_sets(flats, sizes), 20),
            per_set_ms=(per_set, 20),
            zero_ms=(lambda: torch.zeros(total, dtype=torch.bool,
                                         device=dev), 20),
            plain_ms=(lambda: paint_cell_sets_plain(flats, sizes), 5),
            library_ms=(library, 10),
            index_put_into_zeroed_ms=(library_into_zeroed, 10))
        bound = bytes_ / HBM_BYTES_PER_S * 1e3
        rows.append(dict(
            update=name, path=path, sets=[dict(
                set=s, indices=f.numel(), num_cells=n, painted=int(p.sum()),
                mismatched_cells=m) for s, f, n, p, m in zip(
                    names, flats, sizes, plain, bad)],
            mismatched_cells=sum(bad),
            repeat_bit_identical=all(torch.equal(a, b)
                                     for a, b in zip(k1, k2)),
            **times, bytes=bytes_, bound_ms=bound,
            bound_share=bound / times["ms"]))
    ok = mismatched == 0 and all(r["repeat_bit_identical"] for r in rows)
    emit("paint_vs_plain", ok=ok, tolerance="exact", updates=rows)
    if not ok:
        raise SystemExit("paint_cells disagrees with its plain version")
    return rows, mismatched


def phase_probes(dev, kernels):
    """The probe entry point at the TPU probes' shapes, then each workload
    held against its plain version. Returns (launches, rows)."""
    from hector_slam_tpu_torch import probes
    from hector_slam_tpu_torch.ops.matmul_stationary import bf16_ulps
    ws = probes.workloads("all", device=dev)
    reset_counts(kernels)
    timed = probes.run(ws)
    launches = read_counts(kernels)
    issued = {name: sum(r["launches"] for r in timed if r["kernel"] == name)
              for name in kernels}
    clock = probes.sm_clock_mhz()
    extra_reps = {"matmul_stationary": (MM_DENORMAL_REPS,)}
    rows = []
    for w, t in zip(ws, timed):
        lo, hi = w.reps
        checks = []
        for reps in w.reps + extra_reps.get(w.kernel, ()):
            k1, k2, plain = w.call(reps), w.call(reps), w.plain(reps)
            torch.cuda.synchronize()
            ulps = (float(bf16_ulps(k1, plain).max())
                    if w.kernel == "matmul_stationary" else None)
            checks.append(dict(
                reps=reps,
                max_abs_err=float((k1.float() - plain.float()).abs().max()),
                max_ulps=ulps, plain_abs_range=(
                    None if ulps is None else
                    [float(plain.abs().min()), float(plain.abs().max())]),
                agrees=(ulps <= MM_ULPS if ulps is not None
                        else torch.equal(k1, plain)),
                repeat_bit_identical=bool(torch.equal(k1, k2))))
        work_bytes, work_ops = w.work(hi)
        t_bytes = work_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = work_ops / OPS_PER_S[w.op_type] * 1e3
        row = dict(
            t, checks=checks,
            max_abs_err=max(c["max_abs_err"] for c in checks),
            max_ulps=(None if checks[0]["max_ulps"] is None
                      else max(c["max_ulps"] for c in checks)),
            agrees=all(c["agrees"] for c in checks),
            repeat_bit_identical=all(c["repeat_bit_identical"]
                                     for c in checks),
            library_ms=None, library_note=w.library_note or None,
            bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
            bound_ms=max(t_bytes, t_ops))
        if w.kernel in CHAIN_CYCLES_PER_REP:
            # the loop-carried floor: hi reps of dependent latency
            row["chain_floor_ms"] = (hi * CHAIN_CYCLES_PER_REP[w.kernel]
                                     / (clock["sm_clock_mhz"] * 1e3))
        # device times: the plain version at the low rep count, and the
        # library calls at the high one replayed from one CUDA graph, so
        # that their many launches reach the device back to back
        library = ({"library_ms": (probes.graphed(lambda: w.library(hi)), 2)}
                   if w.library else {})
        row.update(device_times(plain_ms=(lambda: w.plain(lo), 2), **library))
        row["host_in"] += [] if t["device_only"] else ["ms"]
        if w.kernel == "matmul_stationary":
            # does the chain's speed depend on its values? ns a rep over
            # normal values (lo .. MM_NORMAL_REPS) and over the denormal
            # and stuck ones (MM_NORMAL_REPS .. hi)
            mid, _ = probes.time_ms(lambda: w.call(MM_NORMAL_REPS),
                                    probes.CALLS)
            row.update(
                ms_normal_end=mid, ns_per_rep_normal=(mid - t["ms_lo"]) * 1e6
                / (MM_NORMAL_REPS - lo), ns_per_rep_denormal=(
                    t["ms_hi"] - mid) * 1e6 / (hi - MM_NORMAL_REPS))
            row["cycles_per_rep"] = (t["ns_per_rep"] * clock["sm_clock_mhz"]
                                     / 1e3)
        rows.append(row)
    long_lines = []
    for name, shape, axis, tile_rows in LONG_LINES:
        w = probes._gather(np.random.default_rng(3), dev, name, "gline", shape,
                           axis, tile_rows)
        row = probes.run_probe(w, probes.card())
        row["checks"] = []
        for reps in w.reps:
            k1, k2, plain = w.call(reps), w.call(reps), w.plain(reps)
            row["checks"].append(dict(
                reps=reps, agrees=bool(torch.equal(k1, plain)),
                repeat_bit_identical=bool(torch.equal(k1, k2))))
        long_lines.append(row)
    ok = (launches == issued and all(
        r["agrees"] and r["repeat_bit_identical"] and r["finite"]
        for r in rows) and all(
        c["agrees"] and c["repeat_bit_identical"]
        for r in long_lines for c in r["checks"]))
    emit("probes", ok=ok, tolerance=f"exact; matmul_stationary <= {MM_ULPS} "
         "bf16 ulps", kernel_launches=launches, issued_launches=issued, **clock,
         chain_cycles_per_rep=CHAIN_CYCLES_PER_REP,
         chain_latency_source="Volta microbenchmark figures (Jia et al. "
         "2018), not measured on this card", probes=rows,
         take_along_long_lines=long_lines)
    if not ok:
        raise SystemExit("a probe kernel failed its checks")
    # where paint_runs' time goes: the launch and barrier, + the fill, +
    # the runs, and a torch.zeros fill alone (after the path's counts were
    # read)
    emit("paint_runs_split", **probes.store_split(dev))
    return launches, rows, long_lines


def probe_entry(name, source, replaces, paths, rows):
    """A probe kernel's kernels-line entry: means over its workloads, each
    launched alike on the probes path; ms and library_ms at the high rep
    count, plain_ms and ms_lo at the low one."""
    mine = [r for r in rows if r["kernel"] == name]

    def mean(key):
        return sum(r[key] for r in mine) / len(mine)

    lib = [r["library_ms"] for r in mine]
    chain = ({"chain_floor_ms": mean("chain_floor_ms"),
              "bound_share": mean("bound_ms") / mean("ms_hi"),
              "chain_floor_share": mean("chain_floor_ms") / mean("ms_hi")}
             if name in CHAIN_CYCLES_PER_REP else {})
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(p[name] for p in paths.values()),
        "launches_by_path": {k: p[name] for k, p in paths.items()},
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms": mean("ms_hi"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": ("operations" if mean("bound_ops_ms")
                     >= mean("bound_bytes_ms") else "bytes"),
        "library_ms": None if None in lib else mean("library_ms"),
        "library_note": mine[0]["library_note"],
        **chain,
        "host_in": sorted({k for r in mine for k in r["host_in"]}),
        "ms_lo": mean("ms_lo"),
        "reps": "ms, bound_ms, library_ms (and chain_floor_ms where given) "
                "at each probe's high rep count; ms_lo, plain_ms at its low "
                "one",
        "workloads": [r["probe"] for r in mine]}


def run_paths(dev):
    """Drives the main path's phases on ``dev`` and returns the kernels
    line's entries."""
    from hector_slam_tpu_torch.ops.dyn_slice import dyn_slice
    from hector_slam_tpu_torch.ops.interp_moments import interp_moments
    from hector_slam_tpu_torch.ops.matmul_stationary import matmul_stationary
    from hector_slam_tpu_torch.ops.paint_cells import paint_cells
    from hector_slam_tpu_torch.ops.paint_runs import paint_runs
    from hector_slam_tpu_torch.ops.take_along import take_along
    kernels = {"interp_moments": interp_moments, "paint_cells": paint_cells,
               "take_along": take_along, "matmul_stationary": matmul_stationary,
               "dyn_slice": dyn_slice, "paint_runs": paint_runs}
    abs_kvp = phase_kernel_vs_plain(dev)
    paths, paint_inputs = {}, {}
    paths["sequential"], (pose, scan) = phase_sequential(kernels)
    paint_inputs["sequential"] = ("single", pose, scan)
    paths["batched"], levels, abs_main = phase_batched(dev, kernels)
    paths["fleet"], (poses, scans) = phase_fleet(kernels)
    paint_inputs["fleet"] = ("per_robot", poses, scans)
    paths["shared_fleet"], (poses, scans) = phase_shared_fleet(kernels)
    paint_inputs["shared_fleet"] = ("shared", poses, scans)
    paint_rows, paint_bad = phase_paint(dev, paint_inputs)
    paths["probes"], probe_rows, long_lines = phase_probes(dev, kernels)
    for name in kernels:
        if not any(p[name] for p in paths.values()):
            raise SystemExit(f"{name} was launched on no main path")

    # launch-weighted means over the main path's level mix (6+4+4 steps)
    total = sum(lv["gn_steps"] for lv in levels)

    def mean(key):
        return sum(lv[key] * lv["gn_steps"] for lv in levels) / total

    # paint: each SLAM path's update weighted by its launches (one each)
    slam_rows = [r for r in paint_rows if r["path"]]
    wsum = sum(paths[r["path"]]["paint_cells"] for r in slam_rows)

    def pmean(key):
        return sum(r[key] * paths[r["path"]]["paint_cells"]
                   for r in slam_rows) / wsum

    def by_path(name):
        return {k: p[name] for k, p in paths.items()}

    pdir = "hector_slam_tpu_torch/csrc/"
    return [{
        "name": "interp_moments",
        "route": "cuda",
        "source": "hector_slam_tpu_torch/csrc/interp_moments.cu",
        "replaces": "hector_slam_tpu/ops/pallas_interp.py:337",
        "launches": sum(by_path("interp_moments").values()),
        "launches_by_path": by_path("interp_moments"),
        "max_abs_err": max(abs_kvp, abs_main),
        "ms": mean("kernel_ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": ("operations" if mean("bound_ops_ms")
                     >= mean("bound_bytes_ms") else "bytes"),
        "library_ms": None,
        "host_in": sorted({k for lv in levels for k in lv["host_in"]}),
    }, {
        "name": "paint_cells",
        "route": "cuda",
        "source": "hector_slam_tpu_torch/csrc/paint_cells.cu",
        "replaces": "tools/probe_mosaic_store.py:55",
        "launches": sum(by_path("paint_cells").values()),
        "launches_by_path": by_path("paint_cells"),
        "max_abs_err": paint_bad,
        "ms": pmean("ms"),
        "plain_ms": pmean("plain_ms"),
        "bound_ms": pmean("bound_ms"),
        "bound_by": "bytes",
        "library_ms": pmean("library_ms"),
        "per_set_ms": pmean("per_set_ms"),
        "host_in": sorted({k for r in slam_rows for k in r["host_in"]}),
        "per_call": "one map update's six cell sets, zero fill included; "
                    "per_set_ms: the same sets as six one-set calls",
    }, dict(probe_entry("take_along", pdir + "take_along.cu",
                        "tools/probe_pallas.py:86", paths, probe_rows),
            also_replaces="tools/probe_pallas.py:116",
            long_line_ms={r["probe"]: r["ms_hi"] for r in long_lines}),
        probe_entry("matmul_stationary", pdir + "matmul_stationary.cu",
                    "tools/probe_pallas.py:144", paths, probe_rows),
        probe_entry("dyn_slice", pdir + "dyn_slice.cu",
                    "tools/probe_pallas.py:188", paths, probe_rows),
        probe_entry("paint_runs", pdir + "paint_runs.cu",
                    "tools/probe_mosaic_store.py:112", paths, probe_rows)]


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
    smi = phase_device()
    phase_build()
    print(json.dumps({"kernels": run_paths(torch.device("cuda"))}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
