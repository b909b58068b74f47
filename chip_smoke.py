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
  4. sequential SLAM — the 435-scan corridor fixture on BENCH_CONFIG
     through run_log (on the card each map update is one raster_paint
     launch, whichever free-set layout is named), held against the
     committed JAX reference trajectory
     (tests/fixtures/corridor_jax_reference.npz): every gate equal, equal
     update counts, pose RMSE < 5 mm; one raster_paint launch a scan
     (every level's cells stored straight into the grids; the update
     runs on every scan and the gate selects) and no paint_cells launch;
     then the same scans twice through
     slam_step(raster_backend="xla") and once more with the default:
     poses, gates and final maps bit-equal, one raster_paint launch a
     scan; ms and scans/s of each replay in call order, and each
     route's stream syncs per gated update and per other scan (torch's
     CUDA sync debug mode, over the first SYNC_COUNT_SCANS scans,
     untimed; the two routes' equal); then seg vs dense: a
     mid-log gated update level by level, the compacted free set within
     its budget and past FORCED_BUDGET (the dense fallback) against the
     dense set, painted by paint_cells (rasterize_scan_seg and
     rasterize_scan), painted grids, occupied sets and truncated counts equal;
     segments, budget, slots and index bytes per level, and the whole
     update_pyramid call of each route, host-fed, in turns;
  5. session — the SlamSession entry point on the same fixture, stamps
     t x 0.025 s: session A (timing_mode "step") through process_ranges,
     which replays slam_step_jit's CUDA graph, poses bit-equal to
     run_log's, gates and RMSE as in 4, one capture and one replay a
     scan, one raster_paint launch a scan (the compiled step updates on
     every scan and the gate selects) and one in the capture's warm-up;
     session B ("phases", 100 scans: match_phase_jit, update_phase_jit)
     bit-equal to A; A kidnapped by (+0.6 m, -0.5 m, +0.25 rad) and recovered by
     relocalize (n = 1024: "quad" through match_hypotheses_jit, then the
     default "pallas" — prune, cascade_refine_jit, 3 launches of the
     moments kernel's level form a replay, one a level) and relocalize_global (defaults: the 65,536-pose sweep
     through residual_for_poses_jit, then cascade_refine_jit), each
     within 0.1 m and 0.05 rad of the pose before the kidnap and held
     against the JAX session's results
     (tests/fixtures/session_jax_reference.npz, written by
     tools/make_torch_session_reference.py): acceptance equal, kidnap
     winners within 5 mm and 0.005 rad, equal free-cell counts; each
     first call one capture per graph (its warm-up launches counted) and
     one replay; the graphs' pool bytes; the global sweep's peak device
     memory; a geotiff written; then, after the path's launch counts
     were read, each recovery from the kidnapped state eagerly (the
     session's compiled routes swapped for their eager functions) and
     graphed, in turns, first call and warm, bit-equal, no capture; each
     compiled call against its eager function on the same inputs; the
     run-once saver (python -m hector_slam_tpu_torch.save_geotiff) on
     the card from a checkpoint of A, its files byte-equal to the CPU's;
     three reset() calls, each followed by a scan, with no capture and no
     new reserved device memory; then the "mxu" kidnap, on the path: a
     session holding JAX's state after the replay (the JAX checkpoint
     in tests/fixtures/queries_jax_reference.npz), kidnapped alike and
     recovered by relocalize(method="mxu") at n = 256 and 1024 through
     match_hypotheses_mxu_jit (one capture, 14 moments launches a
     replay): refine batches, fast-path fraction and overflowed steps
     equal to JAX's (tests/fixtures/mxu_jax_reference.npz, written by
     tools/make_torch_mxu_reference.py), acceptance equal and winners
     within 5 mm and 0.005 rad; each compiled call bit-equal to its
     eager function; first-call and warm ms;
  6. batched matching — the bench.py workload: a map built with known
     poses, 4096 hypotheses (sigma 0.05) matched through
     match_hypotheses_kernel (3 launches of the kernel's level form a
     call, its 14 GN steps inside), a 256-hypothesis subset held against
     the plain batched matcher; at each level's inputs the level form
     (level_ms: its one launch) bit-equal to gn_step_kernel's per-step
     route, its estimates within LEVEL_EST_TOL of its plain loop (plain
     ms beside) and its H within REL_TOL of the plain moments at its
     last step's start, its bound the steps' moments and updates;
     then mxu: the same workload through match_hypotheses_mxu_jit, the
     theta-bucketed patch matcher (bench.py's bucket count): its first
     call and one replay on the path (14 moments launches each, 14 in
     the capture's warm-up), the replay bit-equal to the eager function,
     one capture then none, no stream sync in a replay, poses against
     match_hypotheses_kernel_jit's (p90 < 2e-3, p99 < 5e-2), the diag,
     ms per call graphed and eager and the kernel route's in turns (CUDA
     events, host-fed), the graph's pool and first-call peak memory,
     beside the card's name and power limit;
  7. fleet — fleet_step with 64 robots, a BENCH_CONFIG pyramid each, every
     robot on its own simulated corridor trajectory, 25 steps: robots 0,
     21, 42 and 63 replayed alone through slam_step must agree bit for bit
     (gates, poses, every level's map); steps/s over steps 1-24 (step 0,
     from empty maps, is an untimed warm-up); one raster_paint launch a
     step;
  8. shared fleet — shared_fleet_step with 64 robots in one BENCH_CONFIG
     pyramid, replaying the committed JAX reference's 16 steps
     (tests/fixtures/shared_fleet_jax_reference.npz, written by
     tools/make_torch_fleet_reference.py): gates equal for every robot
     and step, equal update counts, pose RMSE < 1e-4 m, each level's
     counts of cells > 0 and < 0 equal; steps/s over steps 1-15; one
     raster_paint launch a step;
  9. graphs — the compiled entry points as CUDA graphs
     (hector_slam_tpu_torch/core/graphs.py), each bit-equal to the eager
     function it compiles on the inputs above: run_log_jit on the 435
     scans against run_log (poses, metrics, final state; the caller's
     state not donated), the JAX reference's gates (435/435) and RMSE
     < 5 mm, one capture, 435 replays of one raster_paint launch each, no
     stream sync in a whole call (sync debug mode); scans/s in turns
     (run_log, run_log_jit, run_log_jit, run_log) and 40 scans of each
     route under torch.profiler (device ms, device operations and host
     launch calls per scan); match_hypotheses_kernel_jit on the batched
     workload (3 level-form launches a replay) and match_hypotheses_jit
     on 256 of its hypotheses, ms per call in turns; fleet_step_jit and
     shared_fleet_step_jit over the fleet phases' steps (poses, gates,
     final states bit-equal; one raster_paint launch a replay),
     robot-scans/s in turns (the fleet phase's eager run, graphed,
     graphed, eager);
     each graph's launches per replay, warm-up launches and pool bytes;
 10. paint vs plain — paint_cell_sets at the probe's own workload (1024^2,
     65,536 random cells), at the index sets of one update of each of
     the three map-update paths above, as they painted them before
     raster_paint (its six cell sets; the sequential update as the dense
     sets and, ``sequential_seg``, each free set the compacted one
     followed by the dense one, the unchosen one all sentinels) and
     at one rank's first update in phase 13 (row 0, column 0: 32 robots x 576 beams into
     their own grids, 16 robots x 1,152 beams into the shared one, the
     blocks shard_scan and shard_shared_fleet_scan give it): grids
     exactly equal to the plain version's, two launches bit-identical,
     and the update's time as one call (one fill, one launch) and as six
     one-set calls, beside the plain version's, index_put_'s and the
     bytes bound; then raster paint — the map update's rasterization
     and paint in one launch (ops/raster_paint.py) at live40's and
     fleet40's inputs (TUTORIAL_CONFIG: one scan; 8 robots on 8 maps, 1
     and 8 gated; the 8 on one map; a quarter of their beams) and at one
     update of each SLAM path above: grids and truncated counts exactly
     equal to its plain version's and to the index-set chain it replaced
     (index sets in torch ops and paint_cell_sets), two launches
     bit-identical, one launch a call; its time beside the bytes bound,
     the plain version's, the chain's and the zero fill's; then map
     tail — the map update's tail kernel pair
     (ops/map_tail.py) at fleet40's inputs (8 tutorial pyramids, one gate
     a robot) and live40's (one pyramid): each cell model bit-equal to
     its plain version and to the chain it replaced, with 1 and 8 of 8
     robots gated; the log-odds pair's time with 0, 1 and 8 gated (one
     map: 0 and 1) beside the bytes bound, the plain version's and the
     chain's; then robot match — the SLAM step's matcher level as one
     launch (ops/robot_match.py) at TUTORIAL_CONFIG, level by level, for
     one robot (live40's inputs), 8 robots on 8 maps (fleet40's) and 8
     on one shared map: estimates within LEVEL_EST_TOL of its plain loop,
     H within REL_TOL of the plain moments at its last step's start,
     every fleet robot bit-equal to its solo launch, two launches
     bit-identical; its time beside the plain loop's and the bound (the sequential replay of 4 counts its launches: one
     a level a scan);
 11. probes — the cost probes of tools/probe_pallas.py and
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
 12. queries — the query modules on JAX's map: the committed reference
     (tests/fixtures/queries_jax_reference.npz, written on the CPU by
     tools/make_torch_queries_reference.py) is a JAX checkpoint of the
     JAX session's 435-scan replay, which load_state reads onto the card,
     beside JAX's answers: the sigma-point covariance (within 1e-5 of
     max|cov|, exactly symmetric) and likelihood (within 1e-6) at the
     final pose with the last scan; match_pyramid_debug of that scan
     (pose within 1e-4 of JAX's and bit-equal to match_pyramid's traced
     route, the torch ops; match_pyramid's robot kernel route within
     1e-4 of JAX's too; each
     Hessian within 1e-5 of its max|H|, determinants within 1e-4 and
     condition numbers within 1e-3 relative); distance_to_obstacle_batch
     over 65,536 rays of up to 1,024 cells and the scalar raycasts,
     service distances and normals of 64 rays (equal); save_state ->
     load_state round trips of the session state and of the 64-robot
     shared fleet's final state (bit-equal); ms per call; the two query
     graphs (match_pyramid_debug_jit, sigma_point_covariance_jit):
     first call (one capture each) and warm ms against their eager
     functions in turns, bit-equal, no capture when warm;
 13. sharded — parallel/sharded.py on four gloo ranks sharing the card
     (a (robot 2, beam 2) mesh, spawned by run_ranks with a deadline):
     the 64-robot per-robot fleet for 6 steps (poses within 2e-4, gates
     equal, finest maps agreeing on more than 99.9% of cells against the
     unsharded fleet_step run here), the 64-robot shared fleet (bit-equal
     to shared_fleet_step) and shard_hypotheses at B = 4096 (within 1e-6
     of match_hypotheses), each rank's update one raster_paint launch a
     step and the same all-reduces on every step, gated or not (gloo
     runs the step body eagerly); then one NCCL rank running the
     compiled sharded steps (CUDA graphs with the all-reduces inside) of
     both fleets in turns with the body run eagerly, and
     shard_hypotheses: bit-equal to the eager sharded run and to the
     unsharded run of fleet_step_jit,
     shared_fleet_step_jit and match_hypotheses_jit; one capture, then
     none, 0 stream syncs in a replay, one raster_paint launch a rank and
     step, pool bytes, robot-scans/s in turns; launches are counted in
     the ranks, and steps 1-5, the timed ones, hold gated updates of
     both fleets;
 14. the kernels line: per kernel, its launches on the main path (each
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

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REL_TOL = 1e-5          # kernel vs plain, relative to max |moment| per hyp
# level form vs its plain loop, final estimates (map cells for x, y; rad):
# the moments' rounding (REL_TOL) carried through every step's solve
LEVEL_EST_TOL = 1e-3
RMSE_BUDGET_M = 0.005   # port vs JAX pose RMSE, 435-scan sequential replay
SYNC_COUNT_SCANS = 100  # scans whose stream syncs are counted, per route
FORCED_BUDGET = 4       # segments: every level takes the dense fallback
UPDATE_REPS = 50        # timed update_pyramid calls per route and turn
SHARED_RMSE_M = 1e-4    # port vs JAX pose RMSE, shared fleet (see its tests)
FLEET_ROBOTS = 64       # BASELINE config 5: 64 parallel trajectories
FLEET_STEPS = 25        # one untimed warm-up step, then 24 timed
FLEET_CHECKED = (0, 21, 42, 63)   # replayed alone through slam_step
GRAPH_PROFILE_SCANS = 40   # scans traced per route in phase graphs
# the session phase's scenario (tools/make_torch_session_reference.py)
SESSION_STAMP_S = 0.025
SESSION_PHASES_SCANS = 100      # session B, timing_mode="phases"
KIDNAP = np.asarray([0.6, -0.5, 0.25], np.float32)
RELOCALIZE = dict(n_hypotheses=1024, sigma_xy=0.6, sigma_theta=0.3, seed=3)
RECOVERED_M, RECOVERED_RAD = 0.1, 0.05        # recovery bars (test_session)
JAX_WINNER_M, JAX_WINNER_RAD = 0.005, 0.005   # card vs JAX kidnap winner
QUAD_RESIDUAL_REL = 0.1   # "quad" vs "pallas" winner residual (test_session)
# timed calls of each recovery from the kidnapped state, in this order
RECOVERY_TURNS = ("graphed", "eager", "eager", "graphed", "graphed", "eager")
# the session's compiled recovery routes and the eager functions they compile
RECOVERY_ROUTES = {
    "cascade_refine_jit": ("parallel.recovery", "cascade_refine"),
    "match_hypotheses_kernel_jit": ("parallel.kernel_match",
                                    "match_hypotheses_kernel"),
    "match_hypotheses_jit": ("parallel.batch", "match_hypotheses"),
    "match_hypotheses_mxu_jit": ("parallel.onehot_match",
                                 "match_hypotheses_mxu"),
    "residual_for_poses_jit": ("parallel.batch", "residual_for_poses")}
# the "mxu" kidnap: JAX's state after the corridor replay (QUERIES_REF)
# kidnapped by KIDNAP, relocalize(method="mxu") at these sizes, held to
# tests/fixtures/mxu_jax_reference.npz (tools/make_torch_mxu_reference.py)
MXU_REF = ROOT / "tests" / "fixtures" / "mxu_jax_reference.npz"
MXU_SIZES = (256, 1024)
# phase mxu: the patch matcher against the moments kernel's matcher on
# bench.py's workload, pose-difference quantiles as phase batched holds
# the kernel route to the plain matcher (non-converged GN iterates
# amplify a one-ulp cell flip, so no max bar)
MXU_P90_M, MXU_P99_M = 2e-3, 5e-2
MXU_REPS = 10
# the queries phase's reference (tools/make_torch_queries_reference.py)
QUERIES_REF = ROOT / "tests" / "fixtures" / "queries_jax_reference.npz"
QUERY_RAY_CELLS = 1024     # distance_to_obstacle_batch's max_cells
COV_REL, LIKELIHOOD_ABS = 1e-5, 1e-6   # card vs JAX (tests/test_torch_queries)
DEBUG_POSE_M, HESS_REL, DET_REL, COND_REL = 1e-4, 1e-5, 1e-4, 1e-3
NORMAL_ABS = 1e-6
# the sharded phase: four gloo ranks sharing the card on a (robot 2, beam
# 2) mesh, and one NCCL rank; the first SHARDED_STEPS steps of the fleet
# phases' inputs (every robot gates at step 0, the fastest fleet robots
# again at steps 4 and 5, 25 shared-fleet robots at step 5); JAX's bars
# (tests/test_parallel.py:123-131, 143-144)
SHARDED_RANKS, SHARDED_ROBOT_AXIS, SHARDED_STEPS = 4, 2, 6
SHARDED_DEADLINE_S = 300.0   # each start of ranks; killed past it
SHARDED_POSE_M, SHARDED_MAP_AGREE, SHARDED_HYP_M = 2e-4, 0.999, 1e-6
# the NCCL rank's fleets: the compiled sharded step, then the eager one
SHARDED_TURNS = ("step", "eager", "eager", "step")
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s
# and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
OPS_PER_S = {"f32": F32_OPS_PER_S, "bf16": BF16_TENSOR_OPS_PER_S}
MM_ULPS = 2   # matmul_stationary vs plain, bf16 ulps (tests/test_torch_cuda.py)
# the map tail's timed inputs: shares of a map's cells one scan paints
# free and occupied (a UTM-30LX scan in a 12 m room on a 2048^2 map at
# 0.05 m: ~1,081 beams of ~60 cells)
TAIL_FREE_SHARE, TAIL_OCC_SHARE = 0.015, 0.0003
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
# f32 operations of one hypothesis's GN update in the level form: guard 2,
# six cofactors 18, determinant 5, adjugate times the gradient 15, three
# divisions 3, clamp 2, update 3 (sinf/cosf of the new angle uncounted)
SOLVE_OPS = 48
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
        poses.append(state.pose.clone())   # a compiled step reuses it
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


def level_err(got, want):
    """The level form's (estimates, H) against another route's: the worst
    estimate gap over x, y (map cells) and theta (rad), and the worst H gap
    relative to that hypothesis's largest |H| entry. A NaN on one side
    only counts as an infinite gap."""
    def gap(a, b):
        d = (a - b).abs()
        one_nan = a.isnan() ^ b.isnan()
        return torch.where(one_nan, torch.full_like(d, float("inf")),
                           torch.nan_to_num(d, nan=0.0))
    est = gap(got[0], want[0]).max()
    hg, hw = got[1].reshape(-1, 9), want[1].reshape(-1, 9)
    scale = torch.nan_to_num(hw.abs(), nan=0.0).max(-1).values
    rel = gap(hg, hw).max(-1).values / scale.clamp(min=1e-30)
    return float(est), float(rel.max())


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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def phase_device():
    smi = card_line()
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


def count_host_syncs(fn):
    """(fn(), one "site" per stream synchronisation it made): the
    warnings of torch's CUDA sync debug mode, which fire on every
    device->host read and every host->device copy from pageable memory.
    A site is the innermost line of the repository on the Python stack,
    with the innermost line outside it where that differs."""
    import traceback
    import warnings
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if f.filename != warnings.__file__]
        ours = [f for f in stack if f.filename.startswith(str(ROOT))]
        site = (f"{Path(ours[-1].filename).relative_to(ROOT)}:"
                f"{ours[-1].lineno}" if ours else "?")
        if stack and stack[-1] is not (ours[-1] if ours else None):
            site += (f" via {Path(stack[-1].filename).name}:"
                     f"{stack[-1].lineno} {stack[-1].name}")
        sites.append(site)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        sites.clear()   # the first switch in a process synchronises once
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


def host_syncs(step, state, scans, count):
    """Stream synchronisations per gated update and per other scan over
    the first ``count`` scans through ``step(state, scan)``, each scan
    counted alone (untimed), and their sites, summed over the gated
    updates and over the other scans."""
    from collections import Counter
    syncs = {True: [], False: []}
    sites = {True: Counter(), False: Counter()}
    for t in range(count):
        (state, m), where = count_host_syncs(lambda: step(state, scans[t]))
        gated = bool(m.map_updated)
        syncs[gated].append(len(where))
        sites[gated].update(where)
    return dict(per_gated_update=sorted(set(syncs[True])),
                per_other_scan=sorted(set(syncs[False])),
                gated_updates=len(syncs[True]),
                gated_sites=dict(sites[True]), other_sites=dict(sites[False]))


def phase_sequential(kernels):
    """run_log over the corridor fixture (on the card the map update
    paints segment-compacted free sets), held against the JAX reference;
    then the same scans twice through slam_step with raster_backend="xla"
    (the dense sets) and once more with the default, each agreeing bit
    for bit (run_log, xla, xla, seg: each route once early and once
    late in the call, for the rates); then each route's stream syncs per
    scan over the first SYNC_COUNT_SCANS scans."""
    import hector_slam_tpu_torch as ht
    ref = np.load(ROOT / "tests" / "fixtures" / "corridor_jax_reference.npz")
    ranges, laser, _ = ht.load_log(
        str(ROOT / "tests" / "fixtures" / "corridor_utm30lx.npz"))
    cfg = ht.BENCH_CONFIG
    scans = ht.stack_scans([ht.scan_from_ranges(
        r, cfg.map.level_scale(0), laser, cfg.max_beams) for r in ranges])
    one = [ht.Scan(scans.points[t], scans.origo[t], scans.mask[t])
           for t in range(len(ranges))]
    state = ht.init_state(cfg)
    reset_counts(kernels)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, poses_t, metrics = ht.run_log(state, scans, cfg)
    end.record()
    launches = read_counts(kernels)
    ms = start.elapsed_time(end)

    def seg_step(st, sc):
        return ht.slam_step(st, sc, cfg)

    def xla_step(st, sc):
        return ht.slam_step(st, sc, cfg, raster_backend="xla")

    def replay(step):
        """(bit-equal to run_log's, ms, launches, host split) of a
        slam_step loop. The split is on the host clock, scan by scan: a
        scan's update is queued when its step returns and waited for at
        the next scan's first sync, so a gated scan is counted with the
        scan after it."""
        st, poses, gates, stamps = ht.init_state(cfg), [], [], []
        reset_counts(kernels)
        start.record()
        for sc in one:
            st, m = step(st, sc)
            poses.append(st.pose)
            gates.append(m.map_updated)
            stamps.append(time.perf_counter())
        end.record()
        counts = read_counts(kernels)
        gated = torch.stack(gates)
        equal = (torch.equal(torch.stack(poses), poses_t)
                 and torch.equal(gated, metrics.map_updated)
                 and all(torch.equal(a, b)
                         for a, b in zip(state.log_odds, st.log_odds)))
        gated = gated.cpu().numpy()
        took = np.diff(np.asarray(stamps)) * 1e3     # took[t-1]: scan t
        quiet = ~gated[:-1] & ~gated[1:]             # t and t-1 not gated
        hit = np.flatnonzero(gated[1:-1]) + 1        # gated scans t
        split = dict(other_scan_ms_p50=float(np.median(took[quiet])),
                     gated_scan_and_next_ms_mean=float(np.mean(
                         took[hit - 1] + took[hit])))
        return equal, start.elapsed_time(end), counts, split

    xla_equal, xla_ms, xla_launches, xla_split = replay(xla_step)
    xla_equal_2, xla_ms_2, _, xla_split_2 = replay(xla_step)
    seg_equal_2, seg_ms_2, _, seg_split_2 = replay(seg_step)
    replays_equal = xla_equal and xla_equal_2 and seg_equal_2
    syncs = {
        "seg": host_syncs(seg_step, ht.init_state(cfg), one,
                          SYNC_COUNT_SCANS),
        "xla": host_syncs(xla_step, ht.init_state(cfg), one,
                          SYNC_COUNT_SCANS)}

    poses = poses_t.cpu().numpy()
    gates = metrics.map_updated.cpu().numpy()
    rmse = float(np.sqrt(np.mean((poses[:, :2] - ref["poses"][:, :2]) ** 2)))
    yaw_rmse = float(np.sqrt(np.mean(
        (poses[:, 2] - ref["poses"][:, 2]) ** 2)))
    gate_agree = int((gates == ref["map_updated"]).sum())
    count = int(state.map_update_count)
    trunc = int(metrics.truncated_free_cells.sum())
    paints = len(gates)   # one paint launch a scan, gated or not
    ok = (gate_agree == len(gates) and count == int(ref["map_update_count"])
          and rmse < RMSE_BUDGET_M and trunc == 0
          and np.isfinite(poses).all() and poses.shape == ref["poses"].shape
          and launches["raster_paint"] == paints
          and xla_launches["raster_paint"] == paints and replays_equal
          # the index sets are no longer built or painted on the card
          and launches["paint_cells"] == xla_launches["paint_cells"] == 0
          # the matcher: one robot kernel launch a level a scan
          and launches["robot_match_level"] == cfg.map.levels * paints
          and xla_launches["robot_match_level"] == cfg.map.levels * paints
          and launches["interp_moments_level"] == 0
          # the seg route's fallback is chosen on the device: it syncs
          # where the dense route does and nowhere else
          and all(syncs["seg"][k] == syncs["xla"][k]
                  for k in ("per_gated_update", "per_other_scan")))
    emit("sequential_slam", ok=ok, scans=len(gates), ms=ms,
         scans_per_s=len(gates) / (ms / 1e3), gate_agreement=gate_agree,
         map_update_count=count, jax_map_update_count=int(
             ref["map_update_count"]), pose_rmse_m=rmse,
         yaw_rmse_rad=yaw_rmse, max_pose_diff=float(
             np.abs(poses - ref["poses"]).max()), truncated_free_cells=trunc,
         kernel_launches=launches, expected_paint_launches=paints,
         xla_replay=dict(ms=xla_ms, scans_per_s=len(gates) / (xla_ms / 1e3),
                         kernel_launches=xla_launches),
         replays_bit_equal_to_run_log=replays_equal,
         rates_in_call_order={
             "seg run_log": len(gates) / (ms / 1e3),
             "xla": len(gates) / (xla_ms / 1e3),
             "xla again": len(gates) / (xla_ms_2 / 1e3),
             "seg slam_step": len(gates) / (seg_ms_2 / 1e3)},
         host_split_in_call_order={"xla": xla_split,
                                   "xla again": xla_split_2,
                                   "seg slam_step": seg_split_2},
         host_syncs=dict(syncs, scans=SYNC_COUNT_SCANS))
    if not ok:
        raise SystemExit("sequential SLAM disagrees with the JAX reference "
                         "or with its dense-set replays, or its seg route "
                         "syncs where the dense route does not")
    # one gated update's paint inputs: a mid-log scan at its matched pose
    gated = np.flatnonzero(gates)
    t = int(gated[len(gated) // 2])
    return (launches, xla_launches, poses, (poses_t[t], one[t]),
            (scans, state, poses_t, metrics))


def phase_seg_vs_dense(pose, scan):
    """One gated update of the sequential replay, level by level: the
    segment-compacted free set (within its budget, then with
    budget_segments=FORCED_BUDGET, which takes the dense fallback) and
    the dense one, both painted by the kernel, must give equal grids,
    occupied sets and truncated counts."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core.mapping import (
        cell_indices, rasterize_scan, rasterize_scan_seg, seg_cell_indices)
    from hector_slam_tpu_torch.core.matcher import level_points
    cfg = ht.BENCH_CONFIG
    rows = []
    for level in range(cfg.map.levels):
        sx, sy = cfg.map.level_size(level)
        args = ((sy, sx), pose, level_points(scan.points, level),
                level_points(scan.origo, level), scan.mask,
                cfg.map.top_left_offset, cfg.map.level_scale(level),
                cfg.level_max_ray_cells(level))
        free, _, _, _, total, budget = seg_cell_indices(*args)
        dense_free = cell_indices(*args)[0]
        dense = rasterize_scan(*args)
        total = int(total)
        equal = {b: all(torch.equal(a, d) for a, d in zip(
            rasterize_scan_seg(*args, budget_segments=b), dense))
            for b in (0, FORCED_BUDGET)}
        rows.append(dict(
            level=level, segments=total, budget=budget,
            fallback=total > budget, forced_fallback=total > FORCED_BUDGET,
            seg_slots=free.numel(), dense_slots=dense_free.numel(),
            seg_index_bytes=4 * free.numel(),
            dense_index_bytes=4 * dense_free.numel(),
            free_cells=int(dense[0].sum()), occupied_cells=int(dense[1].sum()),
            equal=equal[0], forced_fallback_equal=equal[FORCED_BUDGET]))
    ok = all(r["equal"] and r["forced_fallback_equal"] and r["forced_fallback"]
             for r in rows)
    # the whole update (index sets, the host read, paint, log-odds) per
    # call, host-fed, in the order seg, xla, xla, seg
    levels = ht.init_state(cfg).log_odds
    order = ("seg", "xla", "xla", "seg")
    update_ms = [cuda_ms(lambda: ht.update_pyramid(
        levels, pose, scan, cfg, raster_backend=b), UPDATE_REPS) for b in order]
    emit("seg_vs_dense", ok=ok, tolerance="exact",
         forced_budget=FORCED_BUDGET, levels=rows,
         update_pyramid_ms_host_fed=dict(order=order, ms=update_ms,
                                         reps=UPDATE_REPS))
    if not ok:
        raise SystemExit("the segment-compacted sets differ from the dense "
                         "ones")


def yaw_err(a, b) -> float:
    d = float(a) - float(b)
    return abs(float(np.arctan2(np.sin(d), np.cos(d))))


def timed_call(fn):
    """(result, ms) of one call on the host clock, up to the device's
    completion."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def swapped_recovery_routes(wrap):
    """Within: each compiled route the session calls is replaced by
    ``wrap(name, compiled, eager)``."""
    import importlib

    from hector_slam_tpu_torch import session as session_mod
    saved = {n: getattr(session_mod, n) for n in RECOVERY_ROUTES}
    for name, (mod, fn) in RECOVERY_ROUTES.items():
        eager = getattr(importlib.import_module(
            f"hector_slam_tpu_torch.{mod}"), fn)
        setattr(session_mod, name, wrap(name, saved[name], eager))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(session_mod, name, fn)


def eager_recovery_routes():
    """Within: the session's recoveries run the eager functions their
    compiled routes compile (the port before its recoveries were
    graphed)."""
    return swapped_recovery_routes(lambda name, compiled, eager: eager)


def checked_recovery_routes(results):
    """Within: each compiled route the session calls also runs its eager
    function on the same inputs right after it, and appends to
    ``results[name]`` whether every output tensor is bit-equal."""
    def wrap(name, compiled, eager):
        def call(*args, **kw):
            got = compiled(*args, **kw)
            results.setdefault(name, []).append(
                tree_equal(got, eager(*args, **kw)))
            return got
        return call
    return swapped_recovery_routes(wrap)


def tree_equal(a, b) -> bool:
    """Two (nested) tuples of tensors bit-equal, leaf by leaf."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(tree_equal(x, y) for x, y in zip(a, b))


def same_recovery(a, b) -> bool:
    """Two recovery results equal: the winner's bits, its residual,
    acceptance and improvement (and the global sweep's fields)."""
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) if k == "pose" else a[k] == b[k]
        for k in a)


def phase_session(kernels, run_log_poses):
    """The SlamSession entry point on the corridor fixture at BENCH_CONFIG:
    session A replays all scans through process_ranges ("step"), session
    B the first SESSION_PHASES_SCANS ("phases"); then A is kidnapped and
    recovered by relocalize ("quad", then the default "pallas": prune,
    cascade) and by relocalize_global, through the compiled routes
    (match_hypotheses_jit, cascade_refine_jit: 3 level-form launches of
    the moments kernel a replay, residual_for_poses_jit), each held against
    tests/fixtures/session_jax_reference.npz; then the geotiff export.
    Off the path (after its counts are read): each recovery eagerly and
    graphed in turns, bit-equal; each compiled call against its eager
    function; the run-once saver on the card against the CPU; three
    resets, each followed by a scan, with no capture and no new reserved
    memory. Returns the path's launches."""
    import tempfile

    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core import graphs
    from hector_slam_tpu_torch.export.images import read_png_size
    ref = np.load(ROOT / "tests" / "fixtures" / "session_jax_reference.npz")
    seq = np.load(ROOT / "tests" / "fixtures" / "corridor_jax_reference.npz")
    ranges, laser, _ = ht.load_log(
        str(ROOT / "tests" / "fixtures" / "corridor_utm30lx.npz"))
    cfg = ht.BENCH_CONFIG
    gates = np.zeros(len(ranges), bool)
    scan_index = [0]

    def gated(_):
        gates[scan_index[0]] = True

    a = ht.SlamSession(cfg, laser, on_map_update=gated)
    b = ht.SlamSession(cfg, laser, timing_mode="phases")
    reset_counts(kernels)
    marks = [read_counts(kernels)]
    graph_marks = [graphs.totals()]
    poses_a = []
    for t, r in enumerate(ranges):
        scan_index[0] = t
        poses_a.append(a.process_ranges(r, stamp=t * SESSION_STAMP_S))
    poses_a = np.stack(poses_a)
    marks.append(read_counts(kernels))
    graph_marks.append(graphs.totals())
    poses_b = np.stack([b.process_ranges(r, stamp=t * SESSION_STAMP_S)
                        for t, r in enumerate(
                            ranges[:SESSION_PHASES_SCANS])])
    marks.append(read_counts(kernels))
    graph_marks.append(graphs.totals())

    # A's replay, before the recoveries, the scans after them and the
    # resets move its gates, count and timing
    a_gates = gates.copy()
    a_count = int(a.state.map_update_count)
    stats_a, stats_b = a.timing_stats(), b.timing_stats()
    good = a.pose.copy()
    # a copy: the session's steps update their state in place (donation)
    kidnapped = graphs.fresh(a.state)._replace(pose=torch.from_numpy(
        good + KIDNAP).to(a.device))

    def recover(fn):
        """(result, ms) of one recovery from the kidnapped state, the
        graph counts marked after it."""
        a.state = kidnapped
        out = timed_call(fn)
        marks.append(read_counts(kernels))
        graph_marks.append(graphs.totals())
        return out

    quad, quad_ms = recover(lambda: a.relocalize(method="quad",
                                                 **RELOCALIZE))
    pallas, pallas_ms = recover(lambda: a.relocalize(**RELOCALIZE))
    p_next = a.process_ranges(ranges[-1])
    marks.append(read_counts(kernels))
    graph_marks.append(graphs.totals())
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    glob, glob_ms = recover(a.relocalize_global)
    peak_mem = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        png, tfw = a.save_geotiff(str(Path(tmp) / "session_map"))
        png_size = read_png_size(png)
        tfw_lines = Path(tfw).read_text().split()
    extends = ht.map_extends(a.occupancy_grid())
    launches = read_counts(kernels)
    recovery_graphs = [g._asdict() for g in graphs.stats() if g.name in (
        "match_hypotheses_jit", "cascade_refine_jit",
        "residual_for_poses_jit")]
    cascades = [g for g in recovery_graphs
                if g["name"] == "cascade_refine_jit"]

    # each recovery again from the kidnapped state, eagerly (the compiled
    # routes of the session swapped for their eager functions) and
    # graphed, in turns; then once more with each compiled call held
    # bit-equal to its eager function on the same inputs
    recoveries = {
        "quad": lambda: a.relocalize(method="quad", **RELOCALIZE),
        "pallas": lambda: a.relocalize(**RELOCALIZE),
        "global": a.relocalize_global}
    first_ms = {n: {"graphed": ms} for n, ms in (
        ("quad", quad_ms), ("pallas", pallas_ms), ("global", glob_ms))}
    warm = graphs.totals()
    turns, turns_equal = {}, {}
    for name, fn in recoveries.items():
        with eager_recovery_routes():
            a.state = kidnapped
            first, first_ms[name]["eager"] = timed_call(fn)
        turns[name], turns_equal[name] = [], True
        for label in RECOVERY_TURNS:
            a.state = kidnapped
            if label == "eager":
                with eager_recovery_routes():
                    out, ms = timed_call(fn)
            else:
                out, ms = timed_call(fn)
            turns[name].append((label, ms))
            turns_equal[name] &= same_recovery(out, first)
    graph_equal = {}
    with checked_recovery_routes(graph_equal):
        for fn in recoveries.values():
            a.state = kidnapped
            fn()
    warm_graphs = {k: graphs.totals()[k] - warm[k]
                   for k in ("captures", "replays")}

    # the run-once saver on the card from a checkpoint of session A,
    # against the same checkpoint rendered on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "session_a.npz")
        ht.save_state(ckpt, a.state)
        cli = subprocess.run(
            [sys.executable, "-m", "hector_slam_tpu_torch.save_geotiff",
             "--checkpoint", ckpt, "--out", str(Path(tmp) / "card")],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        from hector_slam_tpu_torch.save_geotiff import main as save_main
        save_main(["--checkpoint", ckpt, "--out", str(Path(tmp) / "cpu"),
                   "--device", "cpu"])
        cli_equal = cli.returncode == 0 and all(
            (Path(tmp) / f"card{ext}").read_bytes()
            == (Path(tmp) / f"cpu{ext}").read_bytes()
            for ext in (".png", ".tfw"))

    # three resets, each followed by one scan: the step graph on these
    # maps is replayed, and no device memory is reserved
    torch.cuda.synchronize()
    reset_from = (graphs.totals()["captures"], torch.cuda.memory_reserved())
    resets = []
    for _ in range(3):
        a.reset()
        a.process_ranges(ranges[0])
        torch.cuda.synchronize()
        resets.append(dict(
            captures=graphs.totals()["captures"] - reset_from[0],
            reserved_bytes=torch.cuda.memory_reserved() - reset_from[1]))

    pool_bytes_total = sum(g.pool_bytes for g in graphs.stats())
    mxu = phase_session_mxu(kernels, laser)
    launches = {k: n + mxu["launches"][k] for k, n in launches.items()}

    def delta(i, name):
        return marks[i + 1][name] - marks[i][name]

    def graph_delta(i, key):
        return graph_marks[i + 1][key] - graph_marks[i][key]

    rmse = float(np.sqrt(np.mean((poses_a[:, :2] - seq["poses"][:, :2])
                                 ** 2)))
    recov = {}
    for name, out in (("quad", quad), ("pallas", pallas), ("global", glob)):
        recov[name] = dict(
            accepted=out["accepted"], pose=out["pose"].tolist(),
            residual=out["residual"],
            err_m=float(np.linalg.norm(out["pose"][:2] - good[:2])),
            err_rad=yaw_err(out["pose"][2], good[2]),
            fast_path_fraction=out["fast_path_fraction"])
    for name, out in (("quad", quad), ("pallas", pallas)):
        recov[name]["vs_jax_m"] = float(np.linalg.norm(
            out["pose"][:2] - ref["relocalize_pose"][:2]))
        recov[name]["vs_jax_rad"] = yaw_err(out["pose"][2],
                                            ref["relocalize_pose"][2])
    recov["global"]["vs_jax_m"] = float(np.linalg.norm(
        glob["pose"][:2] - ref["global_pose"][:2]))
    checks = {
        "a_bit_equal_run_log": bool(np.array_equal(poses_a, run_log_poses)),
        "a_gates_equal_jax": bool((a_gates == seq["map_updated"]).all()),
        "a_update_count": a_count == int(
            seq["map_update_count"]) == int(ref["map_update_count"]),
        "a_rmse": rmse < RMSE_BUDGET_M,
        # slam_step_jit: one graph replay a scan, each painting once (the
        # update runs on every scan and the gate selects), and one
        # capture, whose warm-up paints once
        "a_graph_replays": graph_delta(0, "replays") == len(ranges)
        and graph_delta(0, "captures") == 1,
        "a_paint_per_scan": delta(0, "raster_paint") == len(ranges) + 1
        and delta(0, "paint_cells") == 0
        and delta(0, "interp_moments") == 0,
        "b_graph_replays": graph_delta(1, "replays")
        == 2 * SESSION_PHASES_SCANS and graph_delta(1, "captures") == 2,
        "b_paint_per_scan": delta(1, "raster_paint")
        == SESSION_PHASES_SCANS + 1 and delta(1, "paint_cells") == 0,
        "b_bit_equal_a": bool(np.array_equal(
            poses_b, poses_a[:SESSION_PHASES_SCANS])),
        "recovered": all(v["accepted"] and v["err_m"] < RECOVERED_M
                         and v["err_rad"] < RECOVERED_RAD
                         for v in recov.values()),
        "quad_residual": abs(quad["residual"] - pallas["residual"])
        < QUAD_RESIDUAL_REL * max(pallas["residual"], 1.0),
        # first calls: each capture's warm-up and one replay; the
        # cascade graphs launch the moments kernel's level form once a
        # level, 3 times a replay, and its moments-only form never
        "moments_launches": delta(2, "interp_moments") == 0
        and delta(2, "interp_moments_level") == 0
        and delta(3, "interp_moments_level") == 2 * 3
        and delta(5, "interp_moments_level") == 2 * 3
        and delta(3, "interp_moments") == delta(5, "interp_moments") == 0
        and len(cascades) == 2 and all(
            g["per_replay"]["interp_moments_level"] == 3
            and g["warmup"]["interp_moments_level"] == 3
            and g["per_replay"]["interp_moments"] == 0 for g in cascades),
        "recovery_graphs": [(graph_delta(i, "captures"),
                             graph_delta(i, "replays"))
                            for i in (2, 3, 4, 5)]
        == [(1, 1), (1, 1), (1, 1), (2, 2)] and len(recovery_graphs) == 4,
        "warm_calls_replay": warm_graphs["captures"] == 0
        and warm_graphs["replays"] > 0,
        "graphed_equal_eager": all(turns_equal.values())
        and set(graph_equal) == {"match_hypotheses_jit",
                                 "cascade_refine_jit",
                                 "residual_for_poses_jit"}
        and all(all(v) for v in graph_equal.values()),
        "resets_keep_graph": all(r["captures"] == 0
                                 and r["reserved_bytes"] == 0
                                 for r in resets),
        "save_geotiff_cli": cli_equal,
        "fast_path": pallas["fast_path_fraction"] == 1.0
        and glob["fast_path_fraction"] == 1.0,
        "tracks_after": float(np.linalg.norm(p_next[:2] - good[:2]))
        < RECOVERED_M,
        "jax_accepted": quad["accepted"] == bool(ref["relocalize_accepted"])
        and pallas["accepted"] == bool(ref["relocalize_accepted"])
        and glob["accepted"] == bool(ref["global_accepted"]),
        "jax_winner": all(recov[n]["vs_jax_m"] < JAX_WINNER_M
                          and recov[n]["vs_jax_rad"] < JAX_WINNER_RAD
                          for n in ("quad", "pallas")),
        "jax_n_free_cells": glob["n_free_cells"] == int(
            ref["global_n_free_cells"]),
        "geotiff": png_size[0] > 0 and png_size[1] > 0 and len(tfw_lines)
        == 6,
        "finite": bool(np.isfinite(poses_a).all()
                       and np.isfinite(poses_b).all()),
        **mxu["checks"],
    }
    ok = all(checks.values())
    emit("session", ok=ok, checks=checks, scans=len(ranges),
         phases_scans=SESSION_PHASES_SCANS, pose_rmse_m=rmse,
         gate_agreement=int((a_gates == seq["map_updated"]).sum()),
         map_update_count=a_count,
         ms_per_scan_p50=stats_a["p50_ms"],
         ms_per_scan_mean=stats_a["mean_ms"],
         ms_per_scan_p95=stats_a["p95_ms"],
         phases_ms_per_scan_p50=stats_b["p50_ms"],
         match_p50_ms=stats_b["match_p50_ms"],
         update_p50_ms=stats_b["update_p50_ms"],
         match_mean_ms=stats_b["match_mean_ms"],
         update_mean_ms=stats_b["update_mean_ms"],
         relocalize_quad_ms=quad_ms, relocalize_pallas_ms=pallas_ms,
         relocalize_global_ms=glob_ms, recovery_first_ms=first_ms,
         recovery_warm_ms_in_turns=turns,
         recovery_warm_median_ms={n: {label: float(np.median(
             [ms for lb, ms in t if lb == label]))
             for label in ("graphed", "eager")} for n, t in turns.items()},
         recovery_graph_counts={step: {k: graph_delta(i, k) for k in (
             "captures", "replays")} for i, step in enumerate((
                 "session_a", "session_b", "relocalize_quad",
                 "relocalize_pallas", "track_after", "relocalize_global"))},
         recovery_graphs=recovery_graphs,
         graph_pool_bytes_total=pool_bytes_total, mxu_kidnap=mxu["report"],
         warm_graph_counts=warm_graphs, graphed_equal_eager=graph_equal,
         resets=resets, save_geotiff_cli=dict(
             returncode=cli.returncode, files_equal_cpu=cli_equal,
             stderr=cli.stderr[-2000:]),
         recoveries=recov,
         good_pose=good.tolist(), jax_good_pose=ref["good_pose"].tolist(),
         good_vs_jax_m=float(np.linalg.norm(good[:2]
                                            - ref["good_pose"][:2])),
         jax_relocalize_pose=ref["relocalize_pose"].tolist(),
         jax_global_pose=ref["global_pose"].tolist(),
         n_free_cells=glob["n_free_cells"],
         jax_n_free_cells=int(ref["global_n_free_cells"]),
         sweep_best_residual=glob["sweep_best_residual"],
         global_peak_mem_bytes=peak_mem,
         global_peak_mem_above_state_bytes=peak_mem - base_mem,
         map_extends=extends, geotiff_png_size=list(png_size),
         kernel_launches=launches, launches_by_step={
             step: {k: delta(i, k) for k in kernels} for i, step in
             enumerate(("session_a", "session_b", "relocalize_quad",
                        "relocalize_pallas", "track_after",
                        "relocalize_global"))})
    if not ok:
        raise SystemExit("the session failed its checks: " + ", ".join(
            k for k, v in checks.items() if not v))
    return launches


def phase_session_mxu(kernels, laser):
    """The "mxu" kidnap of phase session, on its path: a session holding
    JAX's state after the corridor replay (QUERIES_REF), kidnapped by
    KIDNAP, recovers by relocalize(method="mxu") at each of MXU_SIZES
    through match_hypotheses_mxu_jit (14 moments launches a replay: the
    full path runs on every GN step and is selected on the device),
    held to JAX's telemetry, refine batch, acceptance and winner
    (MXU_REF). Off the path: each again with the compiled call checked
    against its eager function, then warm and timed. Returns the
    path's launches, the checks and the report."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core import graphs
    ref = np.load(MXU_REF)
    cfg = ht.BENCH_CONFIG
    state = ht.load_state(str(QUERIES_REF), cfg)
    with np.load(QUERIES_REF) as z:
        scan = ht.Scan(*(torch.from_numpy(z[k]).to(state.pose.device)
                         for k in ("scan_points", "scan_origo",
                                   "scan_mask")))
    kidnapped = state._replace(pose=state.pose + torch.from_numpy(
        KIDNAP).to(state.pose.device))
    sess = ht.SlamSession(cfg, laser)
    refine = sess._refine_and_accept
    refined = {}

    def spy(hyp, *args, **kw):
        refined[len(refined)] = hyp.cpu().numpy()
        return refine(hyp, *args, **kw)

    sess._refine_and_accept = spy
    kw = {k: v for k, v in RELOCALIZE.items() if k != "n_hypotheses"}

    def recover(n):
        sess.state = kidnapped
        return sess.relocalize(scan=scan, n_hypotheses=n, method="mxu", **kw)

    reset_counts(kernels)
    before = graphs.totals()
    first = {n: timed_call(lambda: recover(n)) for n in MXU_SIZES}
    launches = read_counts(kernels)
    after = graphs.totals()
    # the most recently used graph of that name (stats are oldest first)
    entry = [g for g in graphs.stats()
             if g.name == "match_hypotheses_mxu_jit"][-1]
    graph_equal = {}
    with checked_recovery_routes(graph_equal):
        again = {n: recover(n) for n in MXU_SIZES}
    warm = {n: [timed_call(lambda: recover(n))[1] for _ in range(3)]
            for n in MXU_SIZES}
    captures = after["captures"] - before["captures"]
    replays = after["replays"] - before["replays"]
    rows, checks = {}, {}
    for i, n in enumerate(MXU_SIZES):
        out, ms = first[n]
        want = ref[f"pose_{n}"]
        rows[n] = dict(
            fast_path_fraction=out["fast_path_fraction"],
            jax_fast_path_fraction=float(ref[f"fast_path_fraction_{n}"]),
            overflow_steps=out["overflow_steps"],
            jax_overflow_steps=int(ref[f"overflow_steps_{n}"]),
            jax_eager_diag=ref[f"eager_diag_{n}"].tolist(),
            accepted=out["accepted"], pose=out["pose"].tolist(),
            residual=out["residual"],
            jax_residual=float(ref[f"residual_{n}"]),
            vs_jax_m=float(np.linalg.norm(out["pose"][:2] - want[:2])),
            vs_jax_rad=yaw_err(out["pose"][2], want[2]),
            refine_equal_jax=bool(np.array_equal(
                refined[i], ref[f"refine_hyp_{n}"])),
            again_equal=same_recovery(again[n], out),
            first_ms=ms, warm_ms=warm[n])
    checks["mxu_telemetry_equal_jax"] = all(
        r["fast_path_fraction"] == r["jax_fast_path_fraction"]
        and r["overflow_steps"] == r["jax_overflow_steps"]
        for r in rows.values())
    checks["mxu_refine_batch_equal_jax"] = all(
        r["refine_equal_jax"] for r in rows.values())
    checks["mxu_winner_jax"] = all(
        r["accepted"] == bool(ref[f"accepted_{n}"])
        and r["vs_jax_m"] < JAX_WINNER_M and r["vs_jax_rad"] < JAX_WINNER_RAD
        for n, r in rows.items())
    checks["mxu_graphed_equal_eager"] = all(
        r["again_equal"] for r in rows.values()) and graph_equal.get(
        "match_hypotheses_mxu_jit") == [True] * len(MXU_SIZES)
    # one graph for the session's map (both batches are 256 wide and
    # take the same bucket count), each capture's warm-up and every
    # replay launching the moments kernel once a GN step
    checks["mxu_launches"] = (
        captures == 1 and replays == len(MXU_SIZES)
        and entry.per_replay["interp_moments"] == 14
        and launches["interp_moments"] == 14 * (captures + replays))
    report = dict(rows={str(n): r for n, r in rows.items()},
                  captures=captures, replays=replays,
                  per_replay=entry.per_replay, warmup=entry.warmup,
                  pool_bytes=entry.pool_bytes, kernel_launches=launches,
                  graphed_equal_eager=graph_equal)
    return dict(launches=launches, checks=checks, report=report)


def phase_mxu(dev, kernels, hyp_inputs):
    """match_hypotheses_mxu_jit, the theta-bucketed patch matcher, at
    bench.py's workload (the batched phase's map, 4096 hypotheses, its
    scan; bench.py's default bucket count): the graph's first call and a
    replay on the path (14 moments launches each and 14 in the capture's
    warm-up: the full path runs on every GN step), then off the path:
    the replay bit-equal to the eager function, one capture then none,
    the stream syncs of a replay, poses against
    match_hypotheses_kernel_jit's by quantiles, the diag, device ms of
    the graphed and eager calls and of the kernel route (CUDA events,
    host-fed), the graph's pool and the peak memory of its first call.
    Returns the path's launches."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core import graphs
    from hector_slam_tpu_torch.core.slam import quads_of
    cfg = ht.BENCH_CONFIG
    levels = [torch.from_numpy(lo).to(dev) for lo in hyp_inputs["levels"]]
    quads = quads_of(levels, cfg.update.cell_model)
    hyp = torch.from_numpy(hyp_inputs["hypotheses"]).to(dev)
    scan = ht.Scan(*(torch.from_numpy(hyp_inputs[f]).to(dev)
                     for f in ("points", "origo", "mask")))
    steps = sum((cfg.match.iterations_finest if lvl == 0
                 else cfg.match.iterations_coarse) + 1
                for lvl in range(cfg.map.levels))

    def graphed():
        return ht.match_hypotheses_mxu_jit(levels, hyp, scan, cfg,
                                           with_diag=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts(kernels)
    before = graphs.totals()
    first, first_ms = timed_call(graphed)
    peak_mem = torch.cuda.max_memory_allocated() - base_mem
    mid = graphs.totals()
    (second, diag), syncs = count_host_syncs(graphed)
    launches = read_counts(kernels)
    after = graphs.totals()
    entry = [g for g in graphs.stats()
             if g.name == "match_hypotheses_mxu_jit"][-1]
    eager, eager_diag = ht.match_hypotheses_mxu(levels, hyp, scan, cfg,
                                                with_diag=True)
    kernel, _ = ht.match_hypotheses_kernel_jit(levels, hyp, scan, cfg,
                                               quads=quads)
    pose, kpose = second.pose.cpu().numpy(), kernel.pose.cpu().numpy()
    diffs = np.abs(pose - kpose).max(-1)
    p50, p90, p99 = (float(np.percentile(diffs, q)) for q in (50, 90, 99))
    diag_list = [float(x) for x in diag]
    times = {}
    for label in ("graphed", "kernel_route", "kernel_route", "graphed"):
        fn = graphed if label == "graphed" else (
            lambda: ht.match_hypotheses_kernel_jit(levels, hyp, scan, cfg,
                                                   quads=quads))
        times.setdefault(label, []).append(cuda_ms(fn, MXU_REPS))
    eager_ms = cuda_ms(lambda: ht.match_hypotheses_mxu(
        levels, hyp, scan, cfg, with_diag=True), 2)
    checks = {
        "bit_equal_eager": tree_equal(first, (second, diag))
        and tree_equal((second, diag), (eager, eager_diag)),
        "one_capture_then_none": mid["captures"] - before["captures"] == 1
        and after["captures"] == mid["captures"]
        and after["replays"] - mid["replays"] == 1,
        "no_sync_in_replay": len(syncs) == 0,
        "launches": launches["interp_moments"] == 3 * steps
        and entry.per_replay["interp_moments"] == steps
        and entry.warmup["interp_moments"] == steps,
        "vs_kernel_route": p90 < MXU_P90_M and p99 < MXU_P99_M,
        "finite": bool(np.isfinite(pose).all()) and pose.shape == (
            hyp.shape[0], 3),
    }
    ok = all(checks.values())
    emit("mxu", ok=ok, checks=checks, card=card_line(),
         hypotheses=hyp.shape[0], num_buckets=0, gn_steps=steps,
         diag=dict(zip(("repaired_queries", "overflow_steps",
                        "total_queries", "slow_queries"), diag_list),
                   fast_path_fraction=float(diag.fast_path_fraction())),
         first_call_ms=first_ms, graphed_ms=times["graphed"],
         kernel_route_ms=times["kernel_route"], eager_ms=eager_ms,
         matches_per_s=hyp.shape[0] / (min(times["graphed"]) / 1e3),
         pool_bytes=entry.pool_bytes, first_call_peak_mem_bytes=peak_mem,
         replay_syncs=syncs, kernel_launches=launches,
         vs_kernel_route_p50=p50, vs_kernel_route_p90=p90,
         vs_kernel_route_p99=p99, vs_kernel_route_max=float(diffs.max()))
    if not ok:
        raise SystemExit("mxu failed its checks: " + ", ".join(
            k for k, v in checks.items() if not v))
    return launches


def phase_batched(dev, kernels):
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.core.matcher import level_points
    from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                    simulate_trajectory)
    from hector_slam_tpu_torch.ops.interp_moments import (
        _launch, interp_moments, interp_moments_level,
        interp_moments_level_plain, interp_moments_plain, prepare)
    from hector_slam_tpu_torch.parallel.kernel_match import gn_step_kernel
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
    # version and its bound; then its level form, all of the level's GN
    # steps in one launch: bit-equal to gn_step_kernel's per-step route
    # (a moments-only launch, then the torch epilogue), beside its plain
    # loop (interp_moments_level_plain on the card) and its bound
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
        gn_steps = (cfg.match.iterations_finest if lvl == 0
                    else cfg.match.iterations_coarse) + 1
        lk = interp_moments_level(*args, gn_steps)
        se, sh = est, None
        for _ in range(gn_steps):
            last_start = se
            se, sh = gn_step_kernel(*args[:2], se, *args[3:])
        est_gap, loop_hess_rel = level_err(
            lk, interp_moments_level_plain(*args, gn_steps))
        # H is summed at the last step's start, and a gap there moves
        # queries across cell edges, where the gradients jump: so H is held
        # to the plain moments at the kernel's own last start
        hess_rel = level_err(lk, (lk[0], interp_moments_plain(
            *args[:2], last_start, *args[3:]).hess))[1]
        levels.append(dict(
            level=lvl, shape=list(shape), gn_steps=gn_steps,
            # the bare launch and the plain version (device times), and
            # the wrapper with its checks, sin/cos, allocation and
            # assembly as a caller sees it (host-bound); the level form's
            # one launch and its plain loop
            **device_times(
                kernel_ms=(lambda: _launch(
                    *args[:3], *bufs[:2], *args[3:], bufs[2]), 50),
                plain_ms=(lambda: interp_moments_plain(*args), 5),
                level_ms=(lambda: interp_moments_level(*args, gn_steps),
                          50),
                level_plain_ms=(
                    lambda: interp_moments_level_plain(*args, gn_steps), 3)),
            wrapper_ms=cuda_ms(lambda: interp_moments(*args), 20),
            bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
            bound_ms=max(t_bytes, t_ops), max_rel_err=rel,
            max_abs_err=abs_, used_equal=bool(torch.equal(k.used, p.used)),
            # every step's moments bound (the kernel reads the grid anew
            # each step) plus each hypothesis's update every step
            level_bound_ms=gn_steps * (max(t_bytes, t_ops) + b * SOLVE_OPS
                                       / F32_OPS_PER_S * 1e3),
            level_bit_equal=bool(
                torch.equal(lk[0].view(torch.int32), se.view(torch.int32))
                and torch.equal(lk[1].view(torch.int32),
                                sh.view(torch.int32))),
            level_max_est_err=est_gap, level_max_hess_rel_err=hess_rel,
            level_loop_hess_rel_err=loop_hess_rel))
        level_in = ht.match_hypotheses_kernel(
            state.log_odds, level_in, scan, cfg, quads=state.quads,
            max_level=lvl, min_level=lvl)[0].pose
    ok = (launches["interp_moments_level"] == cfg.map.levels
          and launches["interp_moments"] == 0 and pose.shape == (b, 3)
          and np.isfinite(pose).all() and np.isfinite(plain).all()
          and p90 < 2e-3 and p99 < 5e-2
          and all(lv["used_equal"] and lv["max_rel_err"] <= REL_TOL
                  and lv["level_bit_equal"]
                  and lv["level_max_est_err"] <= LEVEL_EST_TOL
                  and lv["level_max_hess_rel_err"] <= REL_TOL
                  for lv in levels))
    emit("batched_matching", ok=ok, hypotheses=b, kernel_launches=launches,
         expected_level_launches=cfg.map.levels, gn_steps=steps,
         ms_per_call=ms_call,
         matches_per_s=b / (ms_call / 1e3),
         fast_path_fraction=float(diag.fast_path_fraction()),
         subset_vs_plain_p50=p50, subset_vs_plain_p90=p90,
         subset_vs_plain_p99=p99,
         subset_vs_plain_max=float(diffs.max()), levels=levels)
    if not ok:
        raise SystemExit("batched matching failed its checks")
    inputs = dict(levels=[lo.cpu().numpy() for lo in state.log_odds],
                  hypotheses=hyp.cpu().numpy(),
                  **{f: getattr(scan, f).cpu().numpy()
                     for f in ("points", "origo", "mask")})
    return launches, levels, worst_abs, inputs


def fleet_ranges():
    """Ranges f32[T, R, 1081] of FLEET_ROBOTS robots, each on its own
    corridor trajectory, and each robot's true poses f32[T, R, 3]
    (``tools/torch_sharded_ranks.corridor_fleet``)."""
    from tools.torch_sharded_ranks import corridor_fleet
    return corridor_fleet(FLEET_STEPS, FLEET_ROBOTS)


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
    paints = FLEET_STEPS   # one paint launch a step of the whole fleet

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
        and launches["raster_paint"] == paints and paints > 0
        and launches["paint_cells"] == 0
        and float(np.percentile(err, 90)) < 0.05
        and all(v["gates_equal"] and v["max_pose_diff_m"] <= 1e-6
                and v["maps_bit_equal"] for v in solo.values()))
    emit("fleet", ok=ok, robots=FLEET_ROBOTS, steps=FLEET_STEPS,
         warmup_steps=1, timed_steps=timed, window_s=seconds,
         steps_per_s=timed / seconds,
         robot_scans_per_s=timed * FLEET_ROBOTS / seconds,
         gates_per_step=gates.sum(1).tolist(), map_updates=updates,
         kernel_launches=launches, expected_paint_launches=paints,
         paint_launches_per_step=launches["raster_paint"] / FLEET_STEPS,
         truncated_free_cells=int(sum(m.truncated_free_cells.sum()
                                      for m in metrics)),
         displacement_err_p90_m=float(np.percentile(err, 90)),
         displacement_err_max_m=float(err.max()),
         solo_replays={str(k): v for k, v in solo.items()})
    if not ok:
        raise SystemExit("the fleet failed its checks")
    eager = dict(scans=scans, poses=poses, gates=gates, state=fleet,
                 robot_scans_per_s=timed * FLEET_ROBOTS / seconds)
    return launches, first, scans[:SHARDED_STEPS], eager


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
    paints = steps   # one paint launch a step of the shared map
    ok = (bool((gates == ref["map_updated"]).all())
          and count == int(ref["map_update_count"]) and rmse < SHARED_RMSE_M
          and occ == ref["occupied_cells"].tolist()
          and free == ref["free_cells"].tolist()
          and torch.stack(trunc).cpu().numpy().tolist()
          == ref["truncated_free_cells"].tolist()
          and np.isfinite(poses).all()
          and launches["raster_paint"] == paints and paints > 0
          and launches["paint_cells"] == 0)
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
    eager = dict(scans=scans, poses=poses, gates=gates, state=state,
                 starts=ref["start_poses"],
                 robot_scans_per_s=timed * r / seconds)
    return (launches, first, scans[:SHARDED_STEPS], ref["start_poses"],
            state, eager)


def profile_counts(fn) -> dict:
    """One ``fn()`` under torch.profiler, after an untraced call: wall
    ms, the device ms and count of its kernels and copies, and the host's
    launch calls (kernels one by one, or graphs)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us, ops, calls = 0.0, 0, {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0.0))
            ops += ev.count
        elif "Launch" in ev.key and ev.key.startswith(("cuda", "cu")):
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
    return dict(wall_ms=wall_ms, device_ms=dev_us / 1e3, device_ops=ops,
                host_launch_calls=calls)


def same_state(a, b) -> bool:
    """Every leaf of two SLAM states bit-equal."""
    return all(torch.equal(x, y) for x, y in zip(
        [*a.log_odds, *a.quads, a.pose, a.last_map_update_pose,
         a.covariance, a.step, a.map_update_count],
        [*b.log_odds, *b.quads, b.pose, b.last_map_update_pose,
         b.covariance, b.step, b.map_update_count]))


def phase_graphs(dev, kernels, sequential, hyp_inputs, fleet, shared):
    """The compiled entry points as CUDA graphs (core/graphs.py), each
    held bit-equal to the eager function it compiles, on the inputs of
    the phases above: run_log_jit on the 435-scan log (against run_log,
    and the JAX reference's gates and RMSE; no stream sync in a whole
    call), match_hypotheses_kernel_jit on the batched workload and
    match_hypotheses_jit on 256 of its hypotheses, fleet_step_jit and
    shared_fleet_step_jit over the fleet phases' steps. Rates in turns
    (eager, graphed, graphed, eager), a traced 40-scan replay of each
    route, the graphs' launch counts and pool sizes. Returns the phase's
    launches."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core import graphs
    from hector_slam_tpu_torch.core.slam import quads_of
    ref = np.load(ROOT / "tests" / "fixtures" / "corridor_jax_reference.npz")
    cfg = ht.BENCH_CONFIG
    scans, eager_state, eager_poses, eager_metrics = sequential
    n = scans.points.shape[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graphs.clear()
    reset_counts(kernels)
    checks, out = {}, {}

    def timed(fn):
        """(fn(), ms to the device's completion, ms to fn's return)."""
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        res = fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(end), host_ms

    def stats_of(name):
        return [g._asdict() for g in graphs.stats() if g.name == name]

    # -- sequential: run_log_jit, its first call captures -----------------
    state0 = ht.init_state(cfg, dev)
    fresh0 = graphs.fresh(state0)
    g0, c0 = graphs.totals(), read_counts(kernels)
    (st, poses, metrics), first_ms, _ = timed(
        lambda: ht.run_log_jit(state0, scans, cfg))
    g1, c1 = graphs.totals(), read_counts(kernels)
    [seq_graph] = stats_of("run_log_jit")
    checks["run_log_bit_equal"] = (
        torch.equal(poses, eager_poses) and same_state(st, eager_state)
        and all(torch.equal(a, b) for a, b in zip(metrics, eager_metrics)))
    checks["run_log_not_donated"] = same_state(state0, fresh0)
    host_poses = poses.cpu().numpy()
    gates = metrics.map_updated.cpu().numpy()
    rmse = float(np.sqrt(np.mean((host_poses[:, :2]
                                  - ref["poses"][:, :2]) ** 2)))
    checks["run_log_vs_jax"] = (
        int((gates == ref["map_updated"]).sum()) == n == len(gates)
        and rmse < RMSE_BUDGET_M and np.isfinite(host_poses).all())
    checks["run_log_launches"] = (
        seq_graph["per_replay"] == {"interp_moments": 0,
                                    "interp_moments_level": 0,
                                    "robot_match_level": cfg.map.levels,
                                    "paint_cells": 0, "raster_paint": 1,
                                    "map_tail": 2}
        and g1["replays"] - g0["replays"] == n
        and g1["captures"] - g0["captures"] == 1
        and c1["raster_paint"] - c0["raster_paint"] == n + 1)
    (_, syncs) = count_host_syncs(lambda: ht.run_log_jit(state0, scans, cfg))
    checks["run_log_no_stream_sync"] = syncs == []
    rates = {}

    def eager():
        return ht.run_log(ht.init_state(cfg, dev), scans, cfg)

    def graphed():
        return ht.run_log_jit(state0, scans, cfg)

    for label, fn in (("eager run_log", eager), ("run_log_jit", graphed),
                      ("run_log_jit again", graphed),
                      ("eager run_log again", eager)):
        (_, p, _), ms, host_ms = timed(fn)
        rates[label] = dict(scans_per_s=n / (ms / 1e3), ms_per_scan=ms / n,
                            host_ms_per_scan=host_ms / n,
                            bit_equal=torch.equal(p, eager_poses))
    checks["rates_bit_equal"] = all(r["bit_equal"] for r in rates.values())
    short = ht.Scan(*(f[:GRAPH_PROFILE_SCANS] for f in scans))
    traced = {
        "eager run_log": profile_counts(
            lambda: ht.run_log(ht.init_state(cfg, dev), short, cfg)),
        "run_log_jit": profile_counts(
            lambda: ht.run_log_jit(state0, short, cfg))}
    per_scan = {k: dict(
        wall_ms=t["wall_ms"] / GRAPH_PROFILE_SCANS,
        device_ms=t["device_ms"] / GRAPH_PROFILE_SCANS,
        device_ops=t["device_ops"] / GRAPH_PROFILE_SCANS,
        host_launch_calls={c: v / GRAPH_PROFILE_SCANS
                           for c, v in t["host_launch_calls"].items()})
        for k, t in traced.items()}
    out["sequential"] = dict(
        scans=n, first_call_ms=first_ms, graph=seq_graph,
        gate_agreement=int((gates == ref["map_updated"]).sum()),
        pose_rmse_m=rmse, stream_syncs_in_a_call=len(syncs),
        sync_sites=syncs[:8], rates_in_call_order=rates,
        traced_scans=GRAPH_PROFILE_SCANS, traced_per_scan=per_scan)

    paints = {"sequential": read_counts(kernels)["raster_paint"]}

    # -- batched matching: the kernel route and the plain route -----------
    levels = tuple(torch.from_numpy(lo).to(dev)
                   for lo in hyp_inputs["levels"])
    quads = quads_of(levels, cfg.update.cell_model)
    hyp = torch.from_numpy(hyp_inputs["hypotheses"]).to(dev)
    scan = ht.Scan(*(torch.from_numpy(hyp_inputs[f]).to(dev)
                     for f in ("points", "origo", "mask")))

    def kernel_eager():
        return ht.match_hypotheses_kernel(levels, hyp, scan, cfg,
                                          quads=quads)

    def kernel_graphed():
        return ht.match_hypotheses_kernel_jit(levels, hyp, scan, cfg,
                                              quads=quads)

    def plain_eager():
        return ht.match_hypotheses(levels, hyp[:256], scan, cfg)

    def plain_graphed():
        return ht.match_hypotheses_jit(levels, hyp[:256], scan, cfg)

    want, got = kernel_eager(), kernel_graphed()
    checks["kernel_route_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(want[0] + want[1],
                                          got[0] + got[1]))
    checks["plain_route_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(plain_eager(), plain_graphed()))
    [kgraph] = stats_of("match_hypotheses_kernel_jit")
    [pgraph] = stats_of("match_hypotheses_jit")
    checks["kernel_route_launches"] = kgraph["per_replay"] == {
        "interp_moments": 0, "interp_moments_level": 3,
        "robot_match_level": 0, "paint_cells": 0, "raster_paint": 0,
        "map_tail": 0}
    out["batched"] = dict(
        hypotheses=hyp.shape[0], kernel_graph=kgraph, plain_graph=pgraph,
        plain_hypotheses=256, ms_per_call_in_call_order=[
            (label, cuda_ms(fn, 10)) for label, fn in (
                ("match_hypotheses_kernel", kernel_eager),
                ("match_hypotheses_kernel_jit", kernel_graphed),
                ("match_hypotheses_kernel_jit", kernel_graphed),
                ("match_hypotheses_kernel", kernel_eager),
                ("match_hypotheses", plain_eager),
                ("match_hypotheses_jit", plain_graphed),
                ("match_hypotheses_jit", plain_graphed),
                ("match_hypotheses", plain_eager))])

    # -- the fleets: eager (their phases), graphed, graphed, eager --------
    def fleet_runs(name, jit_step, eager_step, init, ran):
        timed_steps = len(ran["scans"]) - 1
        graphs.clear()
        st, p, m, secs = run_steps(jit_step, init(), ran["scans"])
        [graph] = stats_of(name)
        g_poses = torch.stack(p).cpu().numpy()
        g_gates = torch.stack([x.map_updated for x in m]).cpu().numpy()
        equal = (np.array_equal(g_poses, ran["poses"])
                 and np.array_equal(g_gates, ran["gates"])
                 and same_state(st, ran["state"]))
        del st, p, m
        graphs.clear()
        _, _, _, secs2 = run_steps(jit_step, init(), ran["scans"])
        graphs.clear()
        _, _, _, secs3 = run_steps(eager_step, init(), ran["scans"])
        robots = ran["poses"].shape[1]
        return equal, dict(
            graph=graph, steps=len(ran["scans"]), timed_steps=timed_steps,
            robot_scans_per_s_in_call_order=[
                ("eager (its phase)", ran["robot_scans_per_s"]),
                ("graphed", timed_steps * robots / secs),
                ("graphed again", timed_steps * robots / secs2),
                ("eager again", timed_steps * robots / secs3)])

    marks = read_counts(kernels)["raster_paint"]
    checks["fleet_bit_equal"], out["fleet"] = fleet_runs(
        "fleet_step_jit", lambda s, sc: ht.fleet_step_jit(s, sc, cfg),
        lambda s, sc: ht.fleet_step(s, sc, cfg),
        lambda: ht.init_fleet(cfg, fleet["poses"].shape[1], dev), fleet)
    paints["fleet"] = read_counts(kernels)["raster_paint"] - marks
    marks = read_counts(kernels)["raster_paint"]
    checks["shared_fleet_bit_equal"], out["shared_fleet"] = fleet_runs(
        "shared_fleet_step_jit",
        lambda s, sc: ht.shared_fleet_step_jit(s, sc, cfg),
        lambda s, sc: ht.shared_fleet_step(s, sc, cfg),
        lambda: ht.init_shared_fleet(cfg, shared["poses"].shape[1],
                                     start_poses=shared["starts"],
                                     device=dev), shared)
    paints["shared_fleet"] = read_counts(kernels)["raster_paint"] - marks
    for name in ("fleet", "shared_fleet"):
        checks[f"{name}_launches"] = out[name]["graph"]["per_replay"] == {
            "interp_moments": 0, "interp_moments_level": 0,
            "robot_match_level": cfg.map.levels, "paint_cells": 0,
            "raster_paint": 1, "map_tail": 2}
    launches = read_counts(kernels)
    graphs.clear()
    checks = {k: bool(v) for k, v in checks.items()}
    ok = all(checks.values())
    emit("graphs", ok=ok, checks=checks, kernel_launches=launches,
         paint_launches_by_route=paints, graph_totals=graphs.totals(),
         **out)
    if not ok:
        raise SystemExit("the compiled entry points failed their checks: "
                         + ", ".join(k for k, v in checks.items() if not v))
    return launches, paints


def paint_index_sets(cfg, poses, scan, layout):
    """(names, indices i32, num_cells) of the six cell sets one map update
    paints at these poses: one scan's dense sets (``single``) or its
    segment-compacted ones (``seg``: each free set the compacted one
    followed by the dense one, the one not chosen, on the device, all
    sentinels), R scans into per-robot grids (``per_robot``) or into one
    shared grid (``shared``)."""
    from hector_slam_tpu_torch.core.mapping import _seg_pairs, cell_indices
    from hector_slam_tpu_torch.core.matcher import level_points
    shapes, inputs = [], []
    for level in range(cfg.map.levels):
        sx, sy = cfg.map.level_size(level)
        shapes.append((sy, sx))
        inputs.append((poses, level_points(scan.points, level),
                       level_points(scan.origo, level), scan.mask,
                       cfg.map.top_left_offset, cfg.map.level_scale(level),
                       cfg.level_max_ray_cells(level)))
    if layout == "seg":
        pairs = _seg_pairs(shapes, inputs)[0]
        cells = [sy * sx for sy, sx in shapes]
    else:
        built = [cell_indices(shape, *args, layout == "per_robot")
                 for shape, args in zip(shapes, inputs)]
        pairs = [b[:2] for b in built]
        cells = [b[2] for b in built]
    names, flats, sizes = [], [], []
    for level, (pair, n) in enumerate(zip(pairs, cells)):
        for kind, flat in zip(("free", "occupied"), pair):
            names.append(f"L{level} {kind}")
            flats.append(flat.reshape(-1).contiguous())
            sizes.append(n)
    return names, flats, sizes


def sharded_paint_inputs(fleet_first, shared_first):
    """The first updates one rank of phase_sharded's mesh (row 0, column
    0) paints, as ``phase_paint`` inputs: its block of the per-robot fleet
    (its row's robots, its column's beams) and of the shared fleet (its
    robots, every beam), at the fleet phases' first poses and scans."""
    from hector_slam_tpu_torch.parallel.sharded import (
        Mesh, shard_scan, shard_shared_fleet_scan)
    mesh = Mesh(robot=SHARDED_ROBOT_AXIS,
                beam=SHARDED_RANKS // SHARDED_ROBOT_AXIS, rank=0,
                group=None, beam_group=None)
    (fposes, fscans), (sposes, sscans) = fleet_first, shared_first
    return {
        "sharded": ("per_robot", fposes[:fposes.shape[0] // mesh.robot],
                    shard_scan(fscans, mesh)),
        "sharded_shared": ("shared", sposes[:sposes.shape[0] // mesh.size],
                           shard_shared_fleet_scan(sscans, mesh))}


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


def raster_levels(cfg):
    """``paint_pyramid``'s raster geometry of ``cfg``'s pyramid."""
    from hector_slam_tpu_torch.ops.raster_paint import RasterLevel
    mcfg = cfg.map
    return [RasterLevel(mcfg.level_size(lv)[::-1], 1.0 / (2.0 ** lv),
                        mcfg.top_left_offset, mcfg.level_scale(lv),
                        cfg.level_max_ray_cells(lv))
            for lv in range(mcfg.levels)]


def index_set_chain(levels, poses, scan, layout):
    """The chain raster_paint replaced on the card: every level's index
    sets in torch ops (one scan: the segment-compacted layout and its
    dense fallback; R scans: the dense layout), painted by one
    paint_cell_sets call, and the truncated counts summed over levels."""
    from hector_slam_tpu_torch.core import mapping as tmap
    from hector_slam_tpu_torch.ops.raster_paint import level_scaled
    inputs = [(poses, level_scaled(scan.points, lv),
               level_scaled(scan.origo, lv), scan.mask, lv.offset, lv.scale,
               lv.max_ray_cells) for lv in levels]
    if layout == "single":
        shapes = [lv.shape for lv in levels]
        pairs, counts = tmap._seg_pairs(shapes, inputs)
    else:
        pairs, shapes, counts = zip(*(
            tmap._level_sets(lv.shape, layout == "per_robot", *args)
            for lv, args in zip(levels, inputs)))
    truncated = torch.zeros(poses.shape[:-1], dtype=torch.int32,
                            device=poses.device)
    for t in counts:
        truncated = truncated + t
    return tmap._paint_pairs(pairs, shapes), truncated


def tutorial_paint_inputs(dev):
    """raster_paint's inputs at TUTORIAL_CONFIG (the cells live40 and
    fleet40 run): simulated UTM-30LX scans of the four-room loop at their
    true poses, 8 robots 7 scans apart. {case: (layout, poses, scan)}:
    live40's one scan, fleet40's 8 robots on 8 maps with 1 and with all 8
    gated (an ungated robot's beams masked, as paint_pyramid masks them),
    the 8 on one shared map, and a rank's quarter of fleet40's beams."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.io.simulator import (World, loop_trajectory,
                                                    simulate_trajectory)
    cfg = ht.TUTORIAL_CONFIG
    laser = ht.LaserModel()
    truth = loop_trajectory(754)[10:66:7]
    ranges = simulate_trajectory(World.multi_room(), truth, laser,
                                 range_noise_std=0.01)
    scan = ht.stack_scans([ht.scan_from_ranges(
        r, cfg.map.level_scale(0), laser, cfg.max_beams, device=dev)
        for r in ranges])
    poses = torch.from_numpy(truth).to(dev)
    one_gated = ht.Scan(scan.points, scan.origo, scan.mask & (
        torch.arange(8, device=dev) == 3)[:, None])
    n = scan.points.shape[1] // 4
    return cfg, {
        "live40": ("single", poses[0], ht.Scan(scan.points[0],
                                               scan.origo[0], scan.mask[0])),
        "fleet40_1_gated": ("per_robot", poses, one_gated),
        "fleet40_8_gated": ("per_robot", poses, scan),
        "shared_8": ("shared", poses, scan),
        "fleet40_beam_shard": ("per_robot", poses, ht.Scan(
            scan.points[:, n:2 * n], scan.origo, scan.mask[:, n:2 * n]))}


def phase_raster_paint(dev, inputs):
    """The map update's rasterization and paint in one launch
    (ops/raster_paint.py) at live40's and fleet40's inputs
    (``tutorial_paint_inputs``) and at one update of each SLAM path of
    the phases above (``inputs``: {path: (layout, poses, scan)}, at
    BENCH_CONFIG): grids and truncated counts exactly equal to the plain
    version's and to the index-set chain it replaced, two launches
    bit-identical; its time (one zero fill and one launch) beside the
    bytes bound (every grid byte written once, each beam's point and mask
    read once), the plain version's, the chain's and the fill's alone.
    Returns (rows, mismatched cells and counts)."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.ops.raster_paint import (raster_paint,
                                                        raster_paint_plain)
    tcfg, cases = tutorial_paint_inputs(dev)
    runs = [(name, None, tcfg, *args) for name, args in cases.items()]
    runs += [(f"{path} update", path, ht.BENCH_CONFIG, *args)
             for path, args in inputs.items()]
    rows, mismatched = [], 0
    for name, path, cfg, layout, poses, scan in runs:
        levels = raster_levels(cfg)
        per_robot = layout == "per_robot"
        args = (levels, poses, scan.points, scan.origo, scan.mask, per_robot)
        before = raster_paint.launches
        k1, k2 = raster_paint(*args), raster_paint(*args)
        launches = raster_paint.launches - before
        plain = raster_paint_plain(*args)
        chain_sets, chain_trunc = index_set_chain(levels, poses, scan, layout)

        def off(got, sets, trunc):
            cells = sum(int((a != b).sum()) for pair, want in zip(
                got.sets, sets) for a, b in zip(pair, want))
            return cells + int((got.truncated - trunc).abs().sum())

        bad = off(k1, plain.sets, plain.truncated) + int(
            (k1.level_truncated - plain.level_truncated).abs().sum())
        chain_bad = off(k1, chain_sets, chain_trunc)
        mismatched += bad + chain_bad
        grid_bytes = sum(g.numel() for pair in k1.sets for g in pair)
        beams = scan.mask.numel()
        bytes_ = grid_bytes + 9 * beams * len(levels)
        times = device_times(
            ms=(lambda: raster_paint(*args), 20),
            plain_ms=(lambda: raster_paint_plain(*args), 5),
            chain_ms=(lambda: index_set_chain(levels, poses, scan, layout),
                      10),
            zero_ms=(lambda: torch.zeros(grid_bytes, dtype=torch.uint8,
                                         device=dev), 20))
        bound = bytes_ / HBM_BYTES_PER_S * 1e3
        rows.append(dict(
            update=name, path=path, layout=layout,
            scans=int(scan.mask.shape[0]) if scan.mask.dim() == 2 else 1,
            beams=beams, levels=len(levels), launches_per_call=launches / 2,
            free_cells=int(sum(int(f.sum()) for f, _ in k1.sets)),
            occupied_cells=int(sum(int(o.sum()) for _, o in k1.sets)),
            truncated=int(k1.truncated.sum()), mismatched=bad,
            chain_mismatched=chain_bad,
            repeat_bit_identical=all(
                torch.equal(a, b) for pa, pb in zip(k1.sets, k2.sets)
                for a, b in zip(pa, pb))
            and torch.equal(k1.level_truncated, k2.level_truncated),
            **times, bytes=bytes_, bound_ms=bound,
            bound_share=bound / times["ms"]))
    ok = mismatched == 0 and all(r["repeat_bit_identical"]
                                 and r["launches_per_call"] == 1
                                 for r in rows)
    emit("raster_paint", ok=ok, tolerance="exact", updates=rows)
    if not ok:
        raise SystemExit("raster_paint disagrees with its plain version or "
                         "with the index-set chain")
    return rows, mismatched


def tail_fixture(dev, robots, model, free_share, occ_share, seed=11):
    """The map tail's inputs at the tutorial launch's widths (2048^2 and
    1024^2 levels) for ``robots`` per-robot maps (None: one map), with
    painted cell sets of about a scan's density, their quads packed."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core.slam import quads_of
    cfg = ht.TUTORIAL_CONFIG
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lead = () if robots is None else (robots,)
    chan = (2,) if model == "reflectance" else ()
    shapes = [(cfg.map.size_y >> k, cfg.map.size_x >> k)
              for k in range(cfg.map.levels)]
    levels = tuple((torch.rand(lead + chan + hw, generator=gen, device=dev)
                    - 0.5) * 4.0 for hw in shapes)
    if model != "log_odds":
        levels = tuple(lv.abs().floor() / 4.0 for lv in levels)
    sets = [(torch.rand(lead + hw, generator=gen, device=dev) < free_share,
             torch.rand(lead + hw, generator=gen, device=dev) < occ_share)
            for hw in shapes]
    return levels, quads_of(levels, model), sets


def phase_map_tail(dev):
    """The map tail (ops/map_tail.py) at fleet40's inputs (8 tutorial
    pyramids, one gate a robot) and live40's (one pyramid, one gate):
    each cell model's kernel pair bit-equal to the plain version and to
    the chain it replaced (apply_update, the gate's select, quads_of), at
    1 and 8 of 8 robots gated and at one gated map; then, for the
    log-odds model at TAIL_FREE_SHARE / TAIL_OCC_SHARE of the cells
    painted, the kernel pair's device time with 0, 1 and 8 robots gated
    (one map: gated and not), the plain version's, the chain's with the
    write-back copy a donating step made (the same whatever the gates),
    and the bytes bound: a gated cell's storage (4 B a channel) and cell
    sets (2 B) read once, its quad (16 B) written, and 4 B a changed
    cell written; an ungated map's gate reads not counted."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core import cell_models as cm
    from hector_slam_tpu_torch.core.slam import quads_of
    from hector_slam_tpu_torch.ops.map_tail import map_tail, map_tail_plain
    upd = ht.TUTORIAL_CONFIG.update
    lf, lo = upd.log_odds_free, upd.log_odds_occupied

    def gate_of(robots, gated):
        if robots is None:
            return torch.tensor(bool(gated), device=dev)
        g = torch.zeros(robots, dtype=torch.bool, device=dev)
        g[:gated] = True
        return g

    def chain(levels, sets, gate, model, into=None):
        new = []
        for lv, (free_set, occ_set) in zip(levels, sets):
            u = cm.apply_update(lv, free_set & ~occ_set, occ_set, model,
                                lf, lo)
            g = gate if gate.dim() == 0 else gate.reshape(
                (-1,) + (1,) * (lv.dim() - 1))
            new.append(torch.where(g, u, lv))
        quads = quads_of(new, model)
        if into is not None:   # the donating step's write-back
            for dst, src in zip(into, list(new) + list(quads)):
                dst.copy_(src)
        return tuple(new), quads

    def abs_err(a, b):
        """The largest |a - b|, a NaN on either side counted as inf."""
        return float(torch.nan_to_num((a.double() - b.double()).abs(),
                                      nan=math.inf).max())

    checks, rows, max_err = {}, [], 0.0
    for model in ("log_odds", "simple_count", "reflectance"):
        for robots, gated in ((8, 1), (8, 8), (None, 1)):
            levels, quads, sets = tail_fixture(dev, robots, model, 0.33, 0.1)
            gate = gate_of(robots, gated)
            want = chain(levels, sets, gate, model)
            plain = ([t.clone() for t in levels], [t.clone() for t in quads])
            map_tail_plain(*plain, sets, gate, model, lf, lo)
            map_tail(levels, quads, sets, gate, model, lf, lo)
            torch.cuda.synchronize()
            checks[f"{model}_{robots or 1}_{gated}_bit_equal"] = all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                and torch.equal(a.view(torch.int32), c.view(torch.int32))
                for a, b, c in zip(levels + quads, plain[0] + plain[1],
                                   want[0] + want[1]))
            max_err = max([max_err] + [
                abs_err(a, b) for a, b in zip(
                    levels + quads + levels + quads,
                    plain[0] + plain[1] + list(want[0]) + list(want[1]))])
            del levels, quads, sets, plain, want
    torch.cuda.empty_cache()
    for cell, robots, counts in (("fleet40", 8, (0, 1, 8)),
                                 ("live40", None, (0, 1))):
        levels, quads, sets = tail_fixture(dev, robots, "log_odds",
                                           TAIL_FREE_SHARE, TAIL_OCC_SHARE)
        maps = 1 if robots is None else robots
        cells = sum(lv[0].numel() if robots else lv.numel() for lv in levels)
        once = [t.clone() for t in levels]
        map_tail(once, [q.clone() for q in quads], sets,
                 gate_of(robots, maps), "log_odds", lf, lo)
        changed = sum(int((a != b).sum()) for a, b in zip(once, levels))
        del once
        row = dict(cell=cell, maps=maps, cells_a_map=cells,
                   changed_cells_a_map=changed // maps)
        for gated in counts:
            gate = gate_of(robots, gated)
            row[f"ms_{gated}_gated"] = device_times(t=(
                lambda: map_tail(levels, quads, sets, gate, "log_odds", lf,
                                 lo), 20))["t"]
            bytes_ = gated * (cells * (4 + 2 + 16) + 4 * changed // maps)
            row[f"bound_ms_{gated}_gated"] = bytes_ / HBM_BYTES_PER_S * 1e3
        gate = gate_of(robots, 1)
        into = list(levels) + list(quads)
        row.update(device_times(
            plain_ms=(lambda: map_tail_plain(levels, quads, sets, gate,
                                             "log_odds", lf, lo), 5),
            chain_ms=(lambda: chain(levels, sets, gate, "log_odds", into),
                      5)))
        row["bytes_a_gated_map"] = cells * (4 + 2 + 16) + 4 * changed // maps
        rows.append(row)
        del levels, quads, sets, into
        torch.cuda.empty_cache()
    ok = all(checks.values())
    emit("map_tail", ok=ok, checks=checks, card=card_line(),
         max_abs_err=max_err, free_share=TAIL_FREE_SHARE,
         occ_share=TAIL_OCC_SHARE, timed=rows)
    if not ok:
        raise SystemExit("map_tail disagrees with its plain version or the "
                         "chain: " + ", ".join(k for k, v in checks.items()
                                               if not v))
    return rows, max_err


def robot_match_inputs(dev, robots, maps):
    """The robot kernel's inputs at TUTORIAL_CONFIG, level by level: a
    2048^2 x 2 pyramid mapped from the first 10 simulated UTM-30LX scans of
    the four-room loop at their true poses; ``robots`` scans of the lap
    beyond them, each matched from its true pose moved 2 cm and 0.01 rad;
    ``maps`` "one" (the mapped grid shared, or one robot's own) or
    "per_robot" (a copy a robot, robot r's moved r cells along x, its
    estimate with it). Returns (cfg, [(quads, shape, est, points, mask,
    steps)] coarse to fine)."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.core.matcher import level_points
    from hector_slam_tpu_torch.io.simulator import (World, loop_trajectory,
                                                    simulate_trajectory)
    cfg = ht.TUTORIAL_CONFIG
    laser = ht.LaserModel()
    poses = loop_trajectory(754)[:10 + robots]
    ranges = simulate_trajectory(World.multi_room(), poses, laser,
                                 range_noise_std=0.01)
    scans = [ht.scan_from_ranges(r, cfg.map.level_scale(0), laser,
                                 cfg.max_beams, device=dev) for r in ranges]
    state = ht.init_state(cfg, device=dev)
    for sc, pose in zip(scans[:10], poses[:10]):
        state, _ = ht.slam_step(state, sc, cfg, pose_hint=torch.from_numpy(
            pose).to(dev), map_without_matching=True)
    start = torch.from_numpy(poses[10:]).to(dev) + torch.tensor(
        [0.02, -0.02, 0.01], device=dev)
    out = []
    for level in range(cfg.map.levels - 1, -1, -1):
        shape = tuple(state.log_odds[level].shape)
        quad = state.quads[level]
        est = world_to_map_pose(start, cfg.map.top_left_offset,
                                cfg.map.level_scale(level)).contiguous()
        if maps == "per_robot":
            quad = torch.stack([torch.roll(quad.reshape(shape + (4,)), r,
                                           dims=1).reshape(-1, 4)
                                for r in range(robots)])
            est[:, 0] += torch.arange(robots, device=dev)
        points = torch.stack([level_points(s.points, level)
                              for s in scans[10:]]).contiguous()
        mask = torch.stack([s.mask for s in scans[10:]]).contiguous()
        steps = (cfg.match.iterations_finest if level == 0
                 else cfg.match.iterations_coarse) + 1
        out.append((quad.contiguous(), shape, est, points, mask, steps))
    return cfg, out


def robot_match_bound_ms(args):
    """Least time the card could take for one robot_match_level call on
    these inputs: each step's moments bound (kernel_bound_ms, robot by
    robot on its own grid) plus each robot's update, every step."""
    from hector_slam_tpu_torch.ops.interp_moments import interp_moments_plain
    quad, shape, est, points, mask, steps = args
    per_step = 0.0
    for r in range(est.shape[0]):
        q = quad[r] if quad.dim() == 3 else quad
        one = (q, shape, est[r:r + 1], points[r], mask[r])
        used = interp_moments_plain(*one).used
        per_step += max(kernel_bound_ms(*one, used))
    return steps * (per_step + est.shape[0] * SOLVE_OPS / F32_OPS_PER_S
                    * 1e3)


def phase_robot_match(dev):
    """The SLAM step's matcher level as one launch a level
    (ops/robot_match.py) at TUTORIAL_CONFIG's widths, level by level: one
    robot (live40's inputs), 8 robots on 8 maps (fleet40's) and on one
    shared map. At each, the kernel held to its plain version (the torch
    loop on the card): estimates within LEVEL_EST_TOL (map cells, rad),
    H within REL_TOL of the plain moments at the kernel's own last step's
    start; every fleet robot bit-equal to its solo launch, two launches
    bit-identical. Then its device time (one robot and fleet40's 8),
    beside the plain loop's and the bound."""
    from hector_slam_tpu_torch.core.interp import hessian_derivs_quad
    from hector_slam_tpu_torch.ops import robot_match as rm

    def bits(t):
        return t.contiguous().view(torch.int32)

    rows, checks = [], {}
    for name, robots, maps in (("live40", 1, "one"),
                               ("fleet40", 8, "per_robot"),
                               ("shared8", 8, "one")):
        cfg, levels = robot_match_inputs(dev, robots, maps)
        for args in levels:
            quad, shape, est, points, mask, steps = args
            got = rm.robot_match_level(*args)
            want = rm.robot_match_level_plain(*args)
            start = rm.robot_match_level(*args[:5], steps - 1)[0]
            hess = hessian_derivs_quad(quad, shape, start, points, mask)[0]
            hess_rel = level_err(got, (got[0], hess))[1]
            loop_gap = level_err(got, want)[0]
            again = rm.robot_match_level(*args)
            solo = []
            for r in range(robots):
                q = quad[r].contiguous() if quad.dim() == 3 else quad
                one = rm.robot_match_level(q, shape, est[r:r + 1],
                                           points[r:r + 1], mask[r:r + 1],
                                           steps)
                solo.append(torch.equal(bits(one[0][0]), bits(got[0][r]))
                            and torch.equal(bits(one[1][0]),
                                            bits(got[1][r])))
            key = f"{name}_{shape[0]}"
            checks[key] = (loop_gap <= LEVEL_EST_TOL and hess_rel <= REL_TOL
                           and all(solo) and bool(torch.isfinite(
                               got[0]).all())
                           and torch.equal(bits(again[0]), bits(got[0]))
                           and torch.equal(bits(again[1]), bits(got[1])))
            row = dict(case=name, robots=robots, maps=maps,
                       shape=list(shape), gn_steps=steps,
                       valid_beams=int(mask.sum()) // robots,
                       max_est_err=loop_gap, max_hess_rel_err=hess_rel,
                       solo_bit_equal=all(solo))
            if name != "shared8":
                row.update(device_times(
                    ms=(lambda: rm.robot_match_level(*args), 50),
                    plain_ms=(lambda: rm.robot_match_level_plain(*args), 3)))
                row["bound_ms"] = robot_match_bound_ms(args)
            rows.append(row)
        del levels
        torch.cuda.empty_cache()
    ok = all(checks.values())
    emit("robot_match", ok=ok, checks=checks, card=card_line(), rows=rows)
    if not ok:
        raise SystemExit("robot_match disagrees with its plain version or "
                         "with its solo launches: " + ", ".join(
                             k for k, v in checks.items() if not v))
    return rows


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


def diag_errors(diag, ref) -> dict:
    """The debug diagnostics against JAX's: each iteration's Hessian error
    over its max|H|, and the determinants' and condition numbers' largest
    relative errors."""
    n = len(ref["diag_hessian"])
    h = diag.hessian.cpu().numpy().reshape(n, 9)
    hj = ref["diag_hessian"].reshape(n, 9)
    out = {"hessian": float((np.abs(h - hj).max(1)
                             / np.abs(hj).max(1)).max())}
    for name in ("determinant", "determinant_2d", "condition_num",
                 "condition_num_2d"):
        want = ref[f"diag_{name}"]
        out[name] = float((np.abs(getattr(diag, name).cpu().numpy() - want)
                           / np.abs(want)).max())
    return out


def phase_queries(dev, kernels, shared_state):
    """The query modules on the card, on JAX's map and against JAX's
    answers (QUERIES_REF, written by tools/make_torch_queries_reference.py
    from the JAX session's 435-scan replay on BENCH_CONFIG; the file is a
    JAX checkpoint, so ``load_state`` reads the map from it): the
    sigma-point covariance and likelihood at the final pose with the last
    scan, the debug match of that scan (14 GN iterations), 65,536 batch
    raycasts of up to 1,024 cells, the 64 scalar raycasts, normals and
    service distances, and save_state -> load_state round trips of the
    session state and of the 64-robot shared fleet's final state. Times
    are per call (CUDA events, host-fed; the scalar queries and the
    checkpoints on the host clock). Returns the path's launches: the
    robot kernel's, once a level in each match_pyramid call, and no
    other kernel's."""
    import os
    import tempfile

    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core import covariance as cov_mod
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.io.checkpoint import checkpoint_leaves
    cfg = ht.BENCH_CONFIG
    ref = np.load(QUERIES_REF)
    reset_counts(kernels)
    state, load_jax_ms = timed_call(lambda: ht.load_state(str(QUERIES_REF),
                                                          cfg))
    scan = ht.scan_from_numpy(ref["scan_points"], ref["scan_origo"],
                              ref["scan_mask"])
    pm = world_to_map_pose(state.pose, cfg.map.top_left_offset,
                           cfg.map.level_scale(0))
    lo0 = state.log_odds[0]
    cov = cov_mod.sigma_point_covariance(lo0, pm, scan).cpu().numpy()
    lh = float(cov_mod.likelihood_for_state(lo0, pm, scan))
    start = torch.from_numpy(ref["debug_start"]).to(dev)
    pose, hess, diag = ht.match_pyramid_debug(state.log_odds, start, scan,
                                              cfg, quads=state.quads)
    matched = ht.match_pyramid(state.log_odds, start, scan, cfg,
                               quads=state.quads)
    # the debug match traces every GN step's H, so it takes the torch
    # route, which match_pyramid takes when traced
    matched_torch = ht.match_pyramid(state.log_odds, start, scan, cfg,
                                     quads=state.quads, trace=[])
    occ = ht.to_occupancy_grid_tensor(lo0)
    begins = torch.from_numpy(ref["ray_begins"]).to(dev)
    ends = torch.from_numpy(ref["ray_ends"]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    rays = ht.distance_to_obstacle_batch(occ, begins, ends,
                                         max_cells=QUERY_RAY_CELLS)
    ray_peak = torch.cuda.max_memory_allocated() - base_mem
    occ_np = occ.cpu().numpy()
    meta = ht.grid_meta(cfg.map)
    robot = ref["scalar_robot"]

    def scalar_queries():
        out = []
        for p in ref["scalar_points"]:
            d, hit = ht.distance_to_obstacle(occ_np, meta, robot, p[:2])
            n = ht.get_normal(occ_np, meta, robot, p)
            out.append((d, np.full(2, np.nan) if hit is None else hit,
                        ht.get_distance_to_obstacle(occ_np, meta, robot, p),
                        np.full(2, np.nan) if n is None else n))
        return out

    scalar, scalar_ms = timed_call(scalar_queries)
    d, hits, service, normals = (np.asarray(c) for c in zip(*scalar))
    round_trips = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, st, template in (
                ("session", state, None),
                ("shared_fleet", shared_state, ht.init_shared_fleet(
                    cfg, shared_state.pose.shape[0]))):
            path = os.path.join(tmp, f"{name}.npz")
            _, save_ms = timed_call(lambda: ht.save_state(path, st))
            back, load_ms = timed_call(lambda: ht.load_state(
                path, cfg, template=template))
            round_trips[name] = dict(
                bit_equal=all(torch.equal(a, b) for a, b in zip(
                    checkpoint_leaves(back), checkpoint_leaves(st))) and all(
                    torch.equal(a, b) for a, b in zip(back.quads, st.quads)),
                on_card=back.pose.device == state.pose.device
                and back.pose.device.type == dev.type,
                save_ms=save_ms, load_ms=load_ms,
                bytes=os.path.getsize(path))
    # the two query graphs (match_pyramid_debug_jit,
    # sigma_point_covariance_jit): first calls, each the process's first
    # of its graph (warm-up, capture, one replay), against the eager
    # functions on the same inputs
    from hector_slam_tpu_torch.core import graphs
    captures = graphs.totals()["captures"]
    cov_jit, cov_first_ms = timed_call(
        lambda: cov_mod.sigma_point_covariance_jit(lo0, pm, scan))
    dbg_jit, dbg_first_ms = timed_call(lambda: ht.match_pyramid_debug_jit(
        state.log_odds, start, scan, cfg, quads=state.quads))
    first_captures = graphs.totals()["captures"] - captures
    launches = read_counts(kernels)

    def debug_eager():
        return ht.match_pyramid_debug(state.log_odds, start, scan, cfg,
                                      quads=state.quads)

    def debug_graphed():
        return ht.match_pyramid_debug_jit(state.log_odds, start, scan, cfg,
                                          quads=state.quads)

    def cov_eager():
        return cov_mod.sigma_point_covariance(lo0, pm, scan)

    def cov_graphed():
        return cov_mod.sigma_point_covariance_jit(lo0, pm, scan)

    graph_checks = {
        "covariance_graph_bit_equal": bool(torch.equal(cov_jit, cov_eager())),
        "debug_graph_bit_equal": tree_equal(dbg_jit, debug_eager())
        and tree_equal(dbg_jit, (pose, hess, diag)),
        "graph_captures": first_captures == 2}
    captures = graphs.totals()["captures"]
    query_graphs = {"first_call_ms": {"sigma_point_covariance_jit":
                                      cov_first_ms,
                                      "match_pyramid_debug_jit":
                                      dbg_first_ms}}
    for label, fn, reps in (
            ("covariance eager", cov_eager, 20),
            ("covariance graphed", cov_graphed, 20),
            ("covariance graphed again", cov_graphed, 20),
            ("covariance eager again", cov_eager, 20),
            ("debug eager", debug_eager, 5),
            ("debug graphed", debug_graphed, 5),
            ("debug graphed again", debug_graphed, 5),
            ("debug eager again", debug_eager, 5)):
        query_graphs[label + " ms"] = cuda_ms(fn, reps)
    graph_checks["graph_warm_no_capture"] = (
        graphs.totals()["captures"] == captures)
    graph_checks["graph_warm_bit_equal"] = bool(
        torch.equal(cov_graphed(), cov_eager())) and tree_equal(
        debug_graphed(), debug_eager())
    query_graphs["pool_bytes"] = {
        g.name: g.pool_bytes for g in graphs.stats()
        if g.name in ("sigma_point_covariance_jit",
                      "match_pyramid_debug_jit")}
    # per-call times after the checks (first uses above)
    times = dict(
        covariance_ms=cuda_ms(lambda: cov_mod.sigma_point_covariance(
            lo0, pm, scan), 20),
        likelihood_ms=cuda_ms(lambda: cov_mod.likelihood_for_state(
            lo0, pm, scan), 20),
        debug_ms=cuda_ms(lambda: ht.match_pyramid_debug(
            state.log_odds, start, scan, cfg, quads=state.quads), 5),
        match_pyramid_ms=cuda_ms(lambda: ht.match_pyramid(
            state.log_odds, start, scan, cfg, quads=state.quads), 5),
        raycast_batch_ms=cuda_ms(lambda: ht.distance_to_obstacle_batch(
            occ, begins, ends, max_cells=QUERY_RAY_CELLS), 5),
        scalar_query_ms=scalar_ms / len(scalar),
        load_jax_checkpoint_ms=load_jax_ms)
    errs = diag_errors(diag, ref)
    cov_ref = ref["covariance"]
    checks = {
        "jax_state": bool(np.array_equal(state.pose.cpu().numpy(),
                                         ref["poses"][-1])),
        "covariance": float(np.abs(cov - cov_ref).max())
        <= COV_REL * float(np.abs(cov_ref).max())
        and bool(np.array_equal(cov, cov.T)) and bool(
            (np.diag(cov) >= 0).all()),
        "likelihood": abs(lh - float(ref["likelihood"])) <= LIKELIHOOD_ABS,
        "debug_pose": float(np.abs(pose.cpu().numpy()
                                   - ref["debug_pose"]).max())
        <= DEBUG_POSE_M,
        "debug_bit_equal_match_pyramid": bool(torch.equal(
            pose, matched_torch.pose)),
        "match_pyramid_pose": float(np.abs(matched.pose.cpu().numpy()
                                           - ref["debug_pose"]).max())
        <= DEBUG_POSE_M,
        "debug_diagnostics": errs["hessian"] <= HESS_REL
        and errs["determinant"] <= DET_REL
        and errs["determinant_2d"] <= DET_REL
        and errs["condition_num"] <= COND_REL
        and errs["condition_num_2d"] <= COND_REL
        and diag.hessian.shape == (14, 3, 3)
        and bool(torch.equal(diag.hessian[-1], hess)),
        "raycast_batch": bool(np.array_equal(rays.cpu().numpy(),
                                             ref["ray_distances"])),
        "raycast_scalar": bool(np.array_equal(d, ref["scalar_distances"])
                               and np.array_equal(hits, ref["scalar_hits"],
                                                  equal_nan=True)),
        "service_distances": bool(np.array_equal(
            service, ref["service_distances"])),
        "normals": bool(np.allclose(normals, ref["normals"], rtol=0,
                                    atol=NORMAL_ABS, equal_nan=True)),
        "round_trips": all(v["bit_equal"] and v["on_card"]
                           for v in round_trips.values()),
        # match_pyramid's calls match through the robot kernel, once a
        # level; no other kernel runs here
        "kernels": launches["robot_match_level"] > 0
        and launches["robot_match_level"] % cfg.map.levels == 0
        and not any(n for k, n in launches.items()
                    if k != "robot_match_level"),
        **graph_checks,
    }
    ok = all(checks.values())
    emit("queries", ok=ok, checks=checks, **times, query_graphs=query_graphs,
         covariance_max_abs_err=float(np.abs(cov - cov_ref).max()),
         likelihood=lh, jax_likelihood=float(ref["likelihood"]),
         debug_pose_err_m=float(np.abs(pose.cpu().numpy()
                                       - ref["debug_pose"]).max()),
         debug_errors=errs, condition_num=diag.condition_num.tolist(),
         rays=len(ref["ray_distances"]), rays_hit=int((rays >= 0).sum()),
         raycast_peak_mem_above_inputs_bytes=ray_peak,
         scalar_rays=len(scalar), scalar_hits=int(np.isfinite(
             hits[:, 0]).sum()), round_trips=round_trips,
         kernel_launches=launches)
    if not ok:
        raise SystemExit("the queries failed their checks: " + ", ".join(
            k for k, v in checks.items() if not v))
    return launches


def phase_sharded(dev, kernels, fleet_scans, shared_scans, starts,
                  hyp_inputs):
    """(a) SHARDED_RANKS gloo ranks sharing the card, spawned with
    sharded.run_ranks on a (robot SHARDED_ROBOT_AXIS, beam 2) mesh, run in
    turn: the 64-robot per-robot fleet for SHARDED_STEPS steps on
    the fleet phase's first scans (robots over the rows, the 1152 beams
    over the columns), the 64-robot shared fleet on the shared fleet
    phase's (robots over every rank, the pyramid replicated), and
    shard_hypotheses at B = 4096 on the batched phase's; each is held
    against the same run unsharded in this process: the per-robot fleet
    to JAX's bars (poses within SHARDED_POSE_M, gates equal, the finest
    maps agreeing on more than SHARDED_MAP_AGREE of cells), the shared
    fleet bit for bit (robots only), the hypotheses within
    SHARDED_HYP_M. A gloo group runs the step body eagerly: every rank's
    map update is one raster_paint launch a step, and every rank issues
    the same all-reduces on every step, gated or not. (b) One NCCL rank:
    the compiled sharded steps (CUDA graphs with the group's all-reduces
    inside) of both fleets, in turns with the body run eagerly
    (SHARDED_TURNS), and shard_hypotheses
    (match_hypotheses_jit's graph) beside the eager matcher: each
    bit-equal to the eager sharded run and to the unsharded run of the
    ``*_jit`` entry points here; one capture in the first compiled turn
    and none after, no stream sync in a replay, one raster_paint launch
    a rank and step (and one in the capture's warm-up). Every run, gloo
    or NCCL, launches the map tail twice for each paint. The launches are
    counted in the ranks; the steps after the first (timed) hold gated
    updates of both fleets. Returns the launches the ranks counted,
    summed over them, and the paint launches of each run."""
    import tempfile

    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core import graphs
    from hector_slam_tpu_torch.parallel.sharded import run_ranks
    from tools.torch_sharded_ranks import (fleet_job, hypotheses_job,
                                           run_jobs, shared_fleet_job,
                                           stacked_scans, turn)
    cfg = ht.BENCH_CONFIG
    fleet_in = stacked_scans(fleet_scans)
    shared_in = dict(stacked_scans(shared_scans), start_poses=starts)
    graphs.clear()
    torch.cuda.empty_cache()
    wall = {}
    names = ("fleet", "shared_fleet", "hypotheses", "nccl_fleet",
             "nccl_shared", "nccl_hypotheses")
    with tempfile.TemporaryDirectory() as tmp:
        out = {k: str(Path(tmp) / f"{k}.npz") for k in names}
        jobs = [(fleet_job, (cfg, dev.type, SHARDED_ROBOT_AXIS, fleet_in,
                             out["fleet"])),
                (shared_fleet_job, (cfg, dev.type, SHARDED_ROBOT_AXIS,
                                    shared_in, out["shared_fleet"])),
                (hypotheses_job, (cfg, dev.type, SHARDED_ROBOT_AXIS,
                                  hyp_inputs, out["hypotheses"]))]
        t0 = time.perf_counter()
        run_ranks(run_jobs, SHARDED_RANKS, "gloo", (jobs,),
                  deadline_s=SHARDED_DEADLINE_S)
        wall["gloo_s"] = time.perf_counter() - t0
        jobs = [(fleet_job, (cfg, dev.type, 1, fleet_in, out["nccl_fleet"],
                             SHARDED_TURNS)),
                (shared_fleet_job, (cfg, dev.type, 1, shared_in,
                                    out["nccl_shared"], SHARDED_TURNS)),
                (hypotheses_job, (cfg, dev.type, 1, hyp_inputs,
                                  out["nccl_hypotheses"], ("step", "eager")))]
        t0 = time.perf_counter()
        run_ranks(run_jobs, 1, "nccl", (jobs,),
                  deadline_s=SHARDED_DEADLINE_S)
        wall["nccl_s"] = time.perf_counter() - t0
        got = {k: dict(np.load(v)) for k, v in out.items()}

    # the same runs unsharded, in this process: eager, then compiled
    def unsharded(step, state, scans):
        state, poses, metrics, sec = run_steps(step, state, scans)
        return dict(
            poses=torch.stack(poses).cpu().numpy(),
            gates=torch.stack([m.map_updated for m in metrics]).cpu().numpy(),
            truncated=torch.stack([m.truncated_free_cells
                                   for m in metrics]).cpu().numpy(),
            count=state.map_update_count.cpu().numpy(),
            levels=[lo.cpu().numpy() for lo in state.log_odds], seconds=sec)

    r = fleet_scans[0].mask.shape[0]
    rs = shared_scans[0].mask.shape[0]
    fl_eager = unsharded(lambda st, sc: ht.fleet_step(st, sc, cfg),
                         ht.init_fleet(cfg, r, device=dev), fleet_scans)
    fl_jit = unsharded(lambda st, sc: ht.fleet_step_jit(st, sc, cfg),
                       ht.init_fleet(cfg, r, device=dev), fleet_scans)
    sh_eager = unsharded(lambda st, sc: ht.shared_fleet_step(st, sc, cfg),
                         ht.init_shared_fleet(cfg, rs, start_poses=starts,
                                              device=dev), shared_scans)
    sh_jit = unsharded(lambda st, sc: ht.shared_fleet_step_jit(st, sc, cfg),
                       ht.init_shared_fleet(cfg, rs, start_poses=starts,
                                            device=dev), shared_scans)
    hyp_args = ([torch.from_numpy(lo).to(dev) for lo in hyp_inputs["levels"]],
                torch.from_numpy(hyp_inputs["hypotheses"]).to(dev),
                ht.scan_from_numpy(hyp_inputs["points"], hyp_inputs["origo"],
                                   hyp_inputs["mask"], device=dev), cfg)
    hyp_poses = ht.match_hypotheses(*hyp_args).pose.cpu().numpy()
    hyp_jit = ht.match_hypotheses_jit(*hyp_args).pose.cpu().numpy()
    graphs.clear()
    torch.cuda.empty_cache()
    fposes, fgates = fl_eager["poses"], fl_eager["gates"]
    flevels = fl_eager["levels"]
    sposes, sgates = sh_eager["poses"], sh_eager["gates"]

    fl, sf, hy = (got[k] for k in ("fleet", "shared_fleet", "hypotheses"))
    nf, ns, nh = (got[k] for k in ("nccl_fleet", "nccl_shared",
                                   "nccl_hypotheses"))
    agree = [float(np.mean(fl[f"lo_{k}"] == flevels[k]))
             for k in range(cfg.map.levels)]
    timed = SHARDED_STEPS - 1
    turns = range(len(SHARDED_TURNS))
    compiled = [i for i in turns if SHARDED_TURNS[i] == "step"]

    def launches_of(g, name):
        return sum(int(turn(g, i).get(f"launches_{name}", 0))
                   for i in range(len(g["routes"])))

    launches = {name: sum(launches_of(g, name) for g in got.values())
                for name in kernels}
    paints = {k: launches_of(g, "raster_paint") for k, g in got.items()}
    # every paint is applied by the map tail's two launches
    tails = {k: launches_of(g, "map_tail") for k, g in got.items()}
    # every rank paints once a step, gated or not, and once more in a
    # capture's warm-up (the NCCL rank's first compiled turn); the
    # hypotheses paint nothing
    nccl_paints = sum(SHARDED_STEPS + (i == compiled[0]) for i in turns)
    expected = {"fleet": SHARDED_RANKS * SHARDED_STEPS,
                "shared_fleet": SHARDED_RANKS * SHARDED_STEPS,
                "hypotheses": 0, "nccl_fleet": nccl_paints,
                "nccl_shared": nccl_paints, "nccl_hypotheses": 0}
    # the all-reduces issued in each step of the runs that issue them from
    # Python: the gloo ranks and the NCCL rank's eager turns
    eager_turns = [turn(g, i) for g in (fl, sf)
                   for i in range(len(g["routes"]))] + [
        turn(g, i) for g in (nf, ns) for i in turns if i not in compiled]
    all_reduces = [t["all_reduces"].tolist() for t in eager_turns]

    def levels_of(run):
        return run["levels"] if "levels" in run else [
            run[f"lo_{k}"] for k in range(cfg.map.levels)]

    def bit_equal(a, b):
        return all(np.array_equal(a[k], b[k])
                   for k in ("poses", "gates", "truncated", "count")) and all(
            np.array_equal(x, y) for x, y in zip(levels_of(a), levels_of(b)))

    def rates(g, robots):
        return [timed * robots / float(turn(g, i)["seconds"]) for i in turns]

    nccl = {}
    for name, g, eager, jit in (("fleet", nf, fl_eager, fl_jit),
                                ("shared", ns, sh_eager, sh_jit)):
        nccl[name] = dict(
            bit_equal_eager_sharded=all(bit_equal(turn(g, i), turn(g, 1))
                                        for i in turns),
            bit_equal_unsharded=bit_equal(g, eager),
            bit_equal_unsharded_jit=bit_equal(g, jit),
            captures=[int(turn(g, i)["captures"]) for i in turns],
            syncs_last_step=[int(turn(g, i)["syncs"]) for i in turns],
            pool_bytes=int(g["pool_bytes"]),
            paint_launches=[int(turn(g, i)["launches_raster_paint"])
                            for i in turns],
            paint_launches_per_rank_step=int(turn(g, compiled[-1])[
                "launches_raster_paint"]) / SHARDED_STEPS,
            robot_scans_per_s=dict(zip(
                [f"{i} {SHARDED_TURNS[i]}" for i in turns],
                rates(g, fposes.shape[1] if name == "fleet"
                      else sposes.shape[1]))))
    checks = {
        "fleet_poses": float(np.abs(fl["poses"] - fposes).max())
        <= SHARDED_POSE_M,
        "fleet_gates": bool(np.array_equal(fl["gates"], fgates)),
        "fleet_maps": agree[0] > SHARDED_MAP_AGREE,
        "fleet_gated": bool(fgates[0].all()),
        "shared_bit_equal": bit_equal(sf, sh_eager),
        "hypotheses": float(np.abs(hy["poses"] - hyp_poses).max())
        <= SHARDED_HYP_M,
        "unsharded_jit_bit_equal": bit_equal(fl_jit, fl_eager)
        and bit_equal(sh_jit, sh_eager),
        "nccl_bit_equal": all(v["bit_equal_eager_sharded"]
                              and v["bit_equal_unsharded"]
                              and v["bit_equal_unsharded_jit"]
                              for v in nccl.values()),
        "nccl_captures": all(v["captures"] == [
            int(i == compiled[0]) for i in turns] for v in nccl.values())
        and int(nh["captures"]) == 1 and int(nh["later_captures"]) == 0,
        "nccl_no_sync_in_a_replay": all(
            v["syncs_last_step"][i] == 0 for v in nccl.values()
            for i in compiled) and int(nh["syncs"]) == 0,
        "nccl_hypotheses": bool(
            np.array_equal(nh["poses"], turn(nh, 1)["poses"])
            and np.array_equal(nh["poses"], hyp_jit)
            and np.array_equal(nh["poses"], hyp_poses)),
        "paint_launches": paints == expected
        and launches["interp_moments"] == launches["paint_cells"] == 0,
        "map_tail_launches": tails == {k: 2 * v for k, v in paints.items()},
        # every rank issues the same all-reduces on every step, gated or
        # not
        "same_all_reduces_every_step": all(
            len(set(t["all_reduces"].tolist())) == 1
            and np.array_equal(t["all_reduces"], t["all_reduces_min"])
            for t in eager_turns),
        # the timed steps hold gated updates of both fleets
        "timed_steps_gated": bool(fgates[1:].any() and sgates[1:].any()),
        "finite": bool(np.isfinite(fl["poses"]).all()
                       and np.isfinite(hy["poses"]).all()),
    }
    ok = all(checks.values())
    emit("sharded", ok=ok, checks=checks, ranks=SHARDED_RANKS,
         mesh={"robot": SHARDED_ROBOT_AXIS,
               "beam": SHARDED_RANKS // SHARDED_ROBOT_AXIS},
         backend="gloo, CUDA tensors, the ranks sharing one card (eager "
         "steps); one NCCL rank (compiled steps, eager in turns)",
         steps=SHARDED_STEPS, timed_steps=timed,
         fleet_robots=r, fleet_gates_per_step=fgates.sum(1).tolist(),
         fleet_pose_max_diff_m=float(np.abs(fl["poses"] - fposes).max()),
         fleet_map_agreement_by_level=agree,
         fleet_truncated_equal=bool(np.array_equal(fl["truncated"],
                                                   fl_eager["truncated"])),
         shared_gates_per_step=sgates.sum(1).tolist(),
         hypotheses_max_diff=float(np.abs(hy["poses"] - hyp_poses).max()),
         # rank 0's host seconds for the steps after the first; robot-scans
         # per second of four ranks sharing one card, not a multi-card rate
         sharded_fleet_robot_scans_per_s=timed * r / float(fl["seconds"]),
         unsharded_fleet_robot_scans_per_s=timed * r / fl_eager["seconds"],
         unsharded_fleet_jit_robot_scans_per_s=timed * r / fl_jit["seconds"],
         sharded_shared_robot_scans_per_s=timed * rs / float(sf["seconds"]),
         unsharded_shared_robot_scans_per_s=timed * rs / sh_eager["seconds"],
         unsharded_shared_jit_robot_scans_per_s=timed * rs
         / sh_jit["seconds"],
         sharded_hypotheses_ms=float(hy["seconds"]) * 1e3,
         nccl_turns=list(SHARDED_TURNS), nccl=nccl,
         nccl_hypotheses=dict(
             graphed_ms=float(nh["seconds"]) * 1e3,
             eager_ms=float(turn(nh, 1)["seconds"]) * 1e3,
             captures=int(nh["captures"]),
             later_captures=int(nh["later_captures"]),
             pool_bytes=int(nh["pool_bytes"]), syncs=int(nh["syncs"])),
         wall_s=wall, kernel_launches=launches, paint_launches_by_run=paints,
         expected_paint_launches=expected, map_tail_launches_by_run=tails,
         all_reduces_per_step=all_reduces)
    if not ok:
        raise SystemExit("the sharded runs failed their checks: " + ", ".join(
            k for k, v in checks.items() if not v))
    return launches, paints


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
    from hector_slam_tpu_torch.ops.interp_moments import (
        interp_moments, interp_moments_level)
    from hector_slam_tpu_torch.ops.map_tail import map_tail
    from hector_slam_tpu_torch.ops.matmul_stationary import matmul_stationary
    from hector_slam_tpu_torch.ops.paint_cells import paint_cells
    from hector_slam_tpu_torch.ops.paint_runs import paint_runs
    from hector_slam_tpu_torch.ops.raster_paint import raster_paint
    from hector_slam_tpu_torch.ops.robot_match import robot_match_level
    from hector_slam_tpu_torch.ops.take_along import take_along
    kernels = {"interp_moments": interp_moments,
               "interp_moments_level": interp_moments_level,
               "robot_match_level": robot_match_level,
               "paint_cells": paint_cells, "raster_paint": raster_paint,
               "map_tail": map_tail, "take_along": take_along,
               "matmul_stationary": matmul_stationary,
               "dyn_slice": dyn_slice, "paint_runs": paint_runs}
    abs_kvp = phase_kernel_vs_plain(dev)
    paths, paint_inputs = {}, {}
    (paths["sequential"], paths["sequential_xla"], run_log_poses,
     (pose, scan), sequential) = phase_sequential(kernels)
    phase_seg_vs_dense(pose, scan)
    paint_inputs["sequential_seg"] = ("seg", pose, scan)
    paint_inputs["sequential"] = ("single", pose, scan)
    paths["session"] = phase_session(kernels, run_log_poses)
    paths["batched"], levels, abs_main, hyp_inputs = phase_batched(
        dev, kernels)
    paths["mxu"] = phase_mxu(dev, kernels, hyp_inputs)
    paths["fleet"], fleet_first, fleet_scans, fleet = phase_fleet(kernels)
    paint_inputs["fleet"] = ("per_robot", *fleet_first)
    (paths["shared_fleet"], shared_first, shared_scans, starts,
     shared_state, shared) = phase_shared_fleet(kernels)
    paint_inputs["shared_fleet"] = ("shared", *shared_first)
    paths["graphs"], graph_paints = phase_graphs(
        dev, kernels, sequential, hyp_inputs, fleet, shared)
    del sequential, fleet, shared
    paint_inputs.update(sharded_paint_inputs(fleet_first, shared_first))
    paint_rows, paint_bad = phase_paint(dev, paint_inputs)
    raster_rows, raster_bad = phase_raster_paint(
        dev, {k: v for k, v in paint_inputs.items() if k != "sequential_seg"})
    tail_rows, tail_err = phase_map_tail(dev)
    robot_rows = phase_robot_match(dev)
    paths["probes"], probe_rows, long_lines = phase_probes(dev, kernels)
    paths["queries"] = phase_queries(dev, kernels, shared_state)
    del shared_state
    paths["sharded"], sharded_paints = phase_sharded(
        dev, kernels, fleet_scans, shared_scans, starts, hyp_inputs)
    for name in kernels:
        if not any(p[name] for p in paths.values()):
            raise SystemExit(f"{name} was launched on no main path")

    # launch-weighted means over the main path's level mix (6+4+4 steps)
    total = sum(lv["gn_steps"] for lv in levels)

    def mean(key):
        return sum(lv[key] * lv["gn_steps"] for lv in levels) / total

    # raster_paint: each update shape weighted by the launches painting it
    # (one a scan or step; every layout of the sequential updates paints
    # the same cells); the NCCL rank paints the whole fleet, the gloo
    # ranks their blocks
    weights = {p: paths[p]["raster_paint"] + graph_paints[p]
               for p in ("fleet", "shared_fleet")}
    weights["sequential"] = (paths["sequential"]["raster_paint"]
                             + paths["sequential_xla"]["raster_paint"]
                             + paths["session"]["raster_paint"]
                             + graph_paints["sequential"])
    weights["fleet"] += sharded_paints["nccl_fleet"]
    weights["shared_fleet"] += sharded_paints["nccl_shared"]
    weights["sharded"] = sharded_paints["fleet"]
    weights["sharded_shared"] = sharded_paints["shared_fleet"]
    slam_rows = [r for r in raster_rows if r["path"]]
    wsum = sum(weights[r["path"]] for r in slam_rows)
    [probe_paint] = [r for r in paint_rows if not r["path"]]
    tutorial = {r["update"]: r for r in raster_rows if not r["path"]}

    def pmean(key):
        return sum(r[key] * weights[r["path"]] for r in slam_rows) / wsum

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
        "level_launches": sum(by_path("interp_moments_level").values()),
        "level_launches_by_path": by_path("interp_moments_level"),
        "max_abs_err": max(abs_kvp, abs_main),
        "ms": mean("kernel_ms"),
        "level_ms": {lv["level"]: lv["level_ms"] for lv in levels},
        "level_plain_ms": {lv["level"]: lv["level_plain_ms"]
                           for lv in levels},
        "level_bound_ms": {lv["level"]: lv["level_bound_ms"]
                           for lv in levels},
        "level_bit_equal": all(lv["level_bit_equal"] for lv in levels),
        "level_max_est_err": max(lv["level_max_est_err"] for lv in levels),
        "level_max_hess_rel_err": max(lv["level_max_hess_rel_err"]
                                      for lv in levels),
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
        "ms": probe_paint["ms"],
        "plain_ms": probe_paint["plain_ms"],
        "bound_ms": probe_paint["bound_ms"],
        "bound_by": "bytes",
        "library_ms": probe_paint["library_ms"],
        "per_call": "the probe's 65,536 cells on 1024^2, zero fill "
                    "included; timed: also the map updates' index sets, "
                    "which the SLAM paths paint with raster_paint",
        "timed": paint_rows,
    }, {
        "name": "raster_paint",
        "route": "cuda",
        "source": "hector_slam_tpu_torch/csrc/raster_paint.cu",
        "replaces": "tools/probe_mosaic_store.py:55",
        "replaces_note": "the same TPU kernel as paint_cells, with the index "
                         "sets XLA builds for it: one launch an update",
        "launches": sum(by_path("raster_paint").values()),
        "launches_by_path": by_path("raster_paint"),
        "max_abs_err": raster_bad,
        "ms": pmean("ms"),
        "plain_ms": pmean("plain_ms"),
        "chain_ms": pmean("chain_ms"),
        "bound_ms": pmean("bound_ms"),
        "bound_by": "bytes",
        "library_ms": None,
        "host_in": sorted({k for r in slam_rows for k in r["host_in"]}),
        "live40": {k: tutorial["live40"][k] for k in (
            "ms", "plain_ms", "chain_ms", "zero_ms", "bound_ms")},
        "fleet40": {k: tutorial["fleet40_1_gated"][k] for k in (
            "ms", "plain_ms", "chain_ms", "zero_ms", "bound_ms")},
        "per_call": "one map update, zero fill included, launch-weighted "
                    "over the SLAM paths; chain_ms: the index sets and "
                    "paint_cell_sets it replaced; live40, fleet40: at "
                    "TUTORIAL_CONFIG's inputs",
        "timed": raster_rows,
    }, dict(probe_entry("take_along", pdir + "take_along.cu",
                        "tools/probe_pallas.py:86", paths, probe_rows),
            also_replaces="tools/probe_pallas.py:116",
            long_line_ms={r["probe"]: r["ms_hi"] for r in long_lines}),
        probe_entry("matmul_stationary", pdir + "matmul_stationary.cu",
                    "tools/probe_pallas.py:144", paths, probe_rows),
        probe_entry("dyn_slice", pdir + "dyn_slice.cu",
                    "tools/probe_pallas.py:188", paths, probe_rows),
        probe_entry("paint_runs", pdir + "paint_runs.cu",
                    "tools/probe_mosaic_store.py:112", paths, probe_rows),
        {"name": "map_tail",
         "route": "cuda",
         "source": pdir + "map_tail.cu",
         "replaces": None,
         "replaces_note": "no TPU kernel: the JAX package leaves the "
                          "update, the gate's select and the repack to XLA",
         "launches": sum(by_path("map_tail").values()),
         "launches_by_path": by_path("map_tail"),
         "max_abs_err": tail_err,
         "ms": tail_rows[0]["ms_1_gated"],
         "plain_ms": tail_rows[0]["plain_ms"],
         "chain_ms": tail_rows[0]["chain_ms"],
         "bound_ms": tail_rows[0]["bound_ms_1_gated"],
         "bound_by": "bytes",
         "library_ms": None,
         "per_call": "fleet40's update, 1 of 8 tutorial pyramids gated; "
                     "chain_ms: the torch ops it replaced, write-back "
                     "included",
         "timed": tail_rows},
        {"name": "robot_match",
         "route": "cuda",
         "source": pdir + "robot_match.cu",
         "replaces": "hector_slam_tpu/ops/pallas_interp.py:337",
         "replaces_note": "the same TPU kernel as interp_moments, on the "
                          "SLAM step's paths: a block a robot",
         "launches": sum(by_path("robot_match_level").values()),
         "launches_by_path": by_path("robot_match_level"),
         "max_est_err": max(r["max_est_err"] for r in robot_rows),
         "max_hess_rel_err": max(r["max_hess_rel_err"] for r in robot_rows),
         "ms": sum(r["ms"] for r in robot_rows if r["case"] == "live40"),
         "plain_ms": sum(r["plain_ms"] for r in robot_rows
                         if r["case"] == "live40"),
         "bound_ms": sum(r["bound_ms"] for r in robot_rows
                         if r["case"] == "live40"),
         "bound_by": "bytes and operations, each step",
         "library_ms": None,
         "per_call": "live40's match: both levels of one robot (4 + 6 GN "
                     "steps), one launch each",
         "timed": robot_rows}]


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
