"""Rank jobs for the port's sharded steps
(``hector_slam_tpu_torch/parallel/sharded.py``), started by
``sharded.run_ranks``:

    run_ranks(fleet_job, 4, "gloo", (cfg, "cpu", 2, inputs, out_path))

``tests/test_torch_sharded*.py`` run them on gloo ranks on the CPU,
``chip_smoke.py`` (phase ``sharded``) on four gloo ranks sharing one card
and on one NCCL rank, and this script's modes on NCCL ranks, one card
each. Each job takes its inputs whole, as numpy arrays: every rank builds
the whole state and keeps its block, runs the sharded path, and the
results are gathered to rank 0, which writes them to the npz
``out_path``. Imports no JAX.

A fleet job runs the ``routes`` it is given in turns, each from the same
starting blocks (a route's state from its previous turn is refilled in
place, so a compiled step replays the graph it captured):
  - "step": the library's sharded step (``make_fleet_step``,
    ``make_shared_fleet_step``): a CUDA graph with the group's
    all-reduces inside on an NCCL group with the blocks on the card, the
    step run eagerly otherwise;
  - "eager": the step's body (``fleet_step``/``shared_fleet_step`` given
    the group) run eagerly, the update and its collectives on every step.
Turn 0's fields are written under their names, turn i's with the prefix
``t<i>_``: the steps' poses, gates and counts, the final levels
``lo_<k>``, the launches of each CUDA kernel counted in the ranks (summed
over them), the graph captures of the turn (summed), the all-reduces
issued from Python in each step (the most and the fewest of any rank; a
graph's replay issues its captured ones and counts none), the stream
syncs of its last step (the most of any rank; counted on the card only),
the graph's pool bytes (rank 0's) and the host seconds of the steps after
the first (the first, from empty maps, is a warm-up): rank 0's and the
slowest rank's.

  - ``fleet_job``: the per-robot fleet, robots over the mesh's rows and
    beams over its columns;
  - ``shared_fleet_job``: the shared-map fleet, robots over the whole
    mesh;
  - ``hypotheses_job``: ``shard_hypotheses`` ("step") or the eager
    matcher on the same block ("eager"), the hypothesis axis over the
    whole mesh.

Modes on NCCL ranks, one card a rank (BENCH_CONFIG: 1024^2 @ 0.05 m x 3
levels, the 1081-beam laser padded to 1,152 beams), one or more in a
call:

    python tools/torch_sharded_ranks.py four_cards scaling

``scaling`` prints robot-scans/s of both fleets at 1, 2 and 4 ranks (as
many as there are cards) with 16 robots a rank, 16 steps, the compiled
and the eager route in turns, and the weak-scaling efficiency (rate at n
ranks / (n x the rate at 1)) of each: the port's counterpart of
``tools/bench_scaling.py``'s line. ``four_cards`` runs the 64-robot
per-robot fleet on a (robot 4, beam 1) and a (2, 2) mesh, the 64-robot
shared fleet over four ranks and ``shard_hypotheses`` at B = 4096, all
compiled, and holds them to the same runs unsharded through the
``*_jit`` entry points in one process (robots-only meshes bit-equal; the
beam axis: poses within 2e-4, gates equal, finest maps > 99.9% equal;
hypotheses within 1e-6), one capture a rank, then none, no stream sync
in a replay, one raster_paint launch a rank and step. Each prints one
JSON line and the card's name and power limit, and exits non-zero when a
check fails.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))   # run as a script: the package beside

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from hector_slam_tpu_torch.convert import (fleet_state_from_numpy,  # noqa
                                           scan_from_numpy)
from hector_slam_tpu_torch.core import graphs  # noqa: E402
from hector_slam_tpu_torch.core.collectives import psum  # noqa: E402
from hector_slam_tpu_torch.ops import interp_moments, paint_cells  # noqa
from hector_slam_tpu_torch.ops.map_tail import map_tail  # noqa: E402
from hector_slam_tpu_torch.ops.raster_paint import raster_paint  # noqa
from hector_slam_tpu_torch.ops.robot_match import robot_match_level  # noqa
from hector_slam_tpu_torch.parallel.batch import (  # noqa: E402
    fleet_step, init_fleet, match_hypotheses)
from hector_slam_tpu_torch.parallel.shared_map import (  # noqa: E402
    init_shared_fleet, shared_fleet_step)
from hector_slam_tpu_torch.parallel.sharded import (  # noqa: E402
    _block, gather_fleet_state, gather_rows, gather_shared_fleet_state,
    make_fleet_step, make_mesh, make_shared_fleet_step, shard_fleet_state,
    shard_hypotheses, shard_scan, shard_shared_fleet_scan,
    shard_shared_fleet_state)
from hector_slam_tpu_torch.types import Scan, SlamState  # noqa: E402

KERNELS = {"interp_moments": interp_moments.interp_moments,
           "robot_match_level": robot_match_level,
           "paint_cells": paint_cells.paint_cells,
           "raster_paint": raster_paint, "map_tail": map_tail}
SHARED_REFERENCE = ROOT / "tests" / "fixtures" / "shared_fleet_jax_reference.npz"
ROBOTS = 64              # BASELINE config 5
ROBOTS_PER_RANK = 16     # the scaling mode's weak-scaling unit
SCALING_STEPS = 16       # one warm-up step, then 15 timed
CHECK_STEPS = 6          # four_cards: as chip_smoke's sharded phase
HYPOTHESES = 4096        # bench.py's batch
POSE_M = 2e-4            # the beam axis (tests/test_parallel.py:123-131)
MAP_AGREE = 0.999
HYP_M = 1e-6
TURNS = ("step", "eager", "eager", "step")
DEADLINE_S = 600.0


def _log(message: str) -> None:
    """A progress line on stderr, with the seconds since the process
    started."""
    print(f"[{time.perf_counter() - _T0:8.2f} s] {message}", file=sys.stderr,
          flush=True)


_T0 = time.perf_counter()


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def count_syncs(fn):
    """(fn(), the stream synchronisations it made): the warnings of
    torch's CUDA sync debug mode, which fire on every device->host read
    and every host->device copy from pageable memory."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        caught.clear()   # the first switch in a process synchronises once
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def _leaves(state: SlamState):
    return [t for leaf in state
            for t in (leaf if isinstance(leaf, tuple) else (leaf,))]


def _clone(state: SlamState) -> SlamState:
    return SlamState(*(tuple(t.clone() for t in leaf)
                       if isinstance(leaf, tuple) else leaf.clone()
                       for leaf in state))


def fleet_routes(mesh, cfg):
    """The per-robot fleet's routes on this rank's mesh."""
    group = mesh.beam_group
    return {"step": make_fleet_step(mesh, cfg),
            "eager": lambda st, sc: fleet_step(st, sc, cfg, beam_axis=group)}


def shared_routes(mesh, cfg):
    """The shared-map fleet's routes on this rank's mesh."""
    group = mesh.group
    return {"step": make_shared_fleet_step(mesh, cfg),
            "eager": lambda st, sc: shared_fleet_step(st, sc, cfg,
                                                      robot_axis=group)}


@contextlib.contextmanager
def counting_all_reduces(calls):
    """Inside the block every ``dist.all_reduce`` (the one collective of
    core/collectives.py) adds 1 to ``calls[-1]``."""
    real = dist.all_reduce

    def counted(*args, **kwargs):
        calls[-1] += 1
        return real(*args, **kwargs)

    dist.all_reduce = counted
    try:
        yield
    finally:
        dist.all_reduce = real


def _steps(step, state, scans, device):
    """Runs ``step`` over the scans with the kernel counts set to 0 first.
    Returns (state, metrics per step, poses per step, seconds of the
    steps after the first, launches in this rank, the stream syncs of
    the last step on the card or -1, the all-reduces of each step)."""
    for k in KERNELS.values():
        k.launches = 0
    metrics, poses, t0, syncs, calls = [], [], None, -1, []
    for t, sc in enumerate(scans):
        calls.append(0)
        with counting_all_reduces(calls):
            if t == len(scans) - 1 and torch.device(device).type == "cuda":
                (state, m), syncs = count_syncs(lambda: step(state, sc))
            else:
                state, m = step(state, sc)
        metrics.append(m)
        poses.append(state.pose.clone())   # a compiled step reuses it
        if t == 0:
            _sync(device)
            t0 = time.perf_counter()
    _sync(device)
    seconds = time.perf_counter() - t0
    return state, metrics, poses, seconds, {
        n: k.launches for n, k in KERNELS.items()}, syncs, calls


def _reduced(values, mesh, device, op):
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op, group=mesh.group)
    return t.tolist()


def _pool(name: str) -> int:
    return max([s.pool_bytes for s in graphs.stats() if s.name == name],
               default=0)


def _turns(routes, steps, start, scans, device, mesh, graph):
    """Runs each route in turn from the starting blocks ``start``; yields
    (turn, state, metrics, poses, info) after each, before the next turn
    refills a state."""
    kept = {}
    for i, route in enumerate(routes):
        state = kept.get(route)
        if state is None:
            state = _clone(start)
        else:
            for dst, src in zip(_leaves(state), _leaves(start)):
                dst.copy_(src)
        captures = graphs.totals()["captures"]
        state, metrics, poses, seconds, launches, syncs, calls = _steps(
            steps[route], state, scans, device)
        kept[route] = state
        summed = _reduced([graphs.totals()["captures"] - captures]
                          + [launches[n] for n in KERNELS], mesh, device,
                          dist.ReduceOp.SUM)
        slowest, syncs, *most = _reduced([seconds, syncs] + calls, mesh,
                                         device, dist.ReduceOp.MAX)
        fewest = _reduced(calls, mesh, device, dist.ReduceOp.MIN)
        if mesh.rank == 0:
            _log(f"{graph} on {mesh.size} ranks: turn {i} ({route}) done")
        info = dict(route=route, seconds=seconds, seconds_max=slowest,
                    captures=int(summed[0]), syncs=int(syncs),
                    all_reduces=[int(c) for c in most],
                    all_reduces_min=[int(c) for c in fewest],
                    pool_bytes=_pool(graph),
                    **{f"launches_{n}": int(c)
                       for n, c in zip(KERNELS, summed[1:])})
        yield i, state, metrics, poses, info


def _per_step(tensors, mesh, axis):
    """Per-step tensors [R_local, ...] gathered to rank 0 as [T, R, ...]."""
    full = gather_rows(torch.stack(tensors, 1), mesh, axis)
    return None if full is None else full.transpose(0, 1)


def _save(out_path, fields) -> None:
    np.savez(out_path, **fields)


def _prefixed(i, fields):
    """Turn ``i``'s fields as host copies (a later turn refills the
    tensors of an earlier one), under their output names."""
    prefix = "" if i == 0 else f"t{i}_"
    return {prefix + k: v.detach().cpu().clone().numpy()
            if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in fields.items()}


def turn(got: dict, i: int) -> dict:
    """Turn ``i``'s fields of a job's output, under their own names."""
    if i == 0:
        return {k: v for k, v in got.items() if not (
            k.startswith("t") and k.split("_", 1)[0][1:].isdigit())}
    prefix = f"t{i}_"
    return {k[len(prefix):]: v for k, v in got.items()
            if k.startswith(prefix)}


def _scans(inputs, device):
    return [scan_from_numpy(inputs["points"][t], inputs["origo"][t],
                            inputs["mask"][t], device)
            for t in range(inputs["mask"].shape[0])]


def fleet_job(rank, world_size, cfg, device, robot_axis, inputs, out_path,
              routes=("step",)):
    """``inputs``: points [T, R, N, 2], origo [T, R, 2], mask [T, R, N],
    and optionally ``state``: the ``fleet_state_from_numpy`` arguments of
    the starting fleet (default: ``init_fleet``). Writes per turn poses
    [T, R, 3], gates, truncated and valid-beam counts [T, R], the final
    levels ``lo_<k>`` [R, H, W] and update counts [R]."""
    mesh = make_mesh(robot_axis=robot_axis)
    r = inputs["mask"].shape[1]
    full = (fleet_state_from_numpy(*inputs["state"], cfg, device=device)
            if "state" in inputs else init_fleet(cfg, r, device=device))
    start = shard_fleet_state(full, mesh, cfg)
    del full
    scans = [shard_scan(sc, mesh) for sc in _scans(inputs, device)]
    out = {"routes": list(routes)}
    for i, state, metrics, poses, info in _turns(
            routes, fleet_routes(mesh, cfg), start, scans, device, mesh,
            "sharded_fleet_step"):
        fields = dict(
            poses=_per_step(poses, mesh, "robot"),
            gates=_per_step([m.map_updated for m in metrics], mesh,
                            "robot"),
            truncated=_per_step([m.truncated_free_cells for m in metrics],
                                mesh, "robot"),
            num_valid=_per_step([m.num_valid_beams for m in metrics], mesh,
                                "robot"))
        final = gather_fleet_state(state, mesh)
        if rank == 0:
            out.update(_prefixed(i, dict(
                fields, **info, count=final.map_update_count,
                **{f"lo_{k}": lo for k, lo in enumerate(final.log_odds)})))
        del final
    if rank == 0:
        _save(out_path, out)


def shared_fleet_job(rank, world_size, cfg, device, robot_axis, inputs,
                     out_path, routes=("step",)):
    """``inputs``: points [T, R, N, 2], origo [T, R, 2], mask [T, R, N],
    start_poses [R, 3]. Writes per turn poses [T, R, 3], gates and
    valid-beam counts [T, R], the fleet's truncated counts [T], the final
    levels ``lo_<k>`` [H, W] and the update count."""
    mesh = make_mesh(robot_axis=robot_axis)
    r = inputs["mask"].shape[1]
    full = init_shared_fleet(cfg, r, start_poses=inputs["start_poses"],
                             device=device)
    start = shard_shared_fleet_state(full, mesh, cfg)
    del full
    scans = [shard_shared_fleet_scan(sc, mesh)
             for sc in _scans(inputs, device)]
    out = {"routes": list(routes)}
    for i, state, metrics, poses, info in _turns(
            routes, shared_routes(mesh, cfg), start, scans, device, mesh,
            "shared_fleet_step_jit"):
        fields = dict(
            poses=_per_step(poses, mesh, "mesh"),
            gates=_per_step([m.map_updated for m in metrics], mesh, "mesh"),
            num_valid=_per_step([m.num_valid_beams for m in metrics], mesh,
                                "mesh"))
        final = gather_shared_fleet_state(state, mesh)
        if rank == 0:
            out.update(_prefixed(i, dict(
                fields, **info, truncated=torch.stack(
                    [m.truncated_free_cells for m in metrics]),
                count=final.map_update_count,
                **{f"lo_{k}": lo for k, lo in enumerate(final.log_odds)})))
        del final
    if rank == 0:
        _save(out_path, out)


def hypotheses_job(rank, world_size, cfg, device, robot_axis, inputs,
                   out_path, routes=("step",)):
    """``inputs``: levels (a list of [H, W] log-odds), hypotheses [H, 3],
    and the scan's points [N, 2], origo [2], mask [N]. Writes per turn
    the matched poses [H, 3] and Hessians [H, 3, 3], and for one call
    after a first: rank 0's and the slowest rank's seconds, the stream
    syncs, and the captures of both calls."""
    mesh = make_mesh(robot_axis=robot_axis)
    pyramid = [torch.from_numpy(np.asarray(lo, np.float32)).to(device)
               for lo in inputs["levels"]]
    hyps = torch.from_numpy(np.asarray(inputs["hypotheses"],
                                       np.float32)).to(device)
    scan = scan_from_numpy(inputs["points"], inputs["origo"], inputs["mask"],
                           device)
    calls = {"step": shard_hypotheses(mesh, cfg),
             "eager": lambda p, h, s: match_hypotheses(
                 p, _block(h, mesh.rank, mesh.size), s, cfg)}
    out = {"routes": list(routes)}
    for i, route in enumerate(routes):
        fn = calls[route]
        for k in KERNELS.values():
            k.launches = 0
        captures = graphs.totals()["captures"]
        fn(pyramid, hyps, scan)
        first = graphs.totals()["captures"] - captures
        _sync(device)
        t0 = time.perf_counter()
        if torch.device(device).type == "cuda":
            result, syncs = count_syncs(lambda: fn(pyramid, hyps, scan))
        else:
            result, syncs = fn(pyramid, hyps, scan), -1
        _sync(device)
        seconds = time.perf_counter() - t0
        later = graphs.totals()["captures"] - captures - first
        summed = _reduced([first, later] + [k.launches
                                            for k in KERNELS.values()],
                          mesh, device, dist.ReduceOp.SUM)
        slowest, syncs = _reduced([seconds, syncs], mesh, device,
                                  dist.ReduceOp.MAX)
        if mesh.rank == 0:
            _log(f"hypotheses on {mesh.size} ranks: turn {i} ({route}) done")
        pose = gather_rows(result.pose, mesh, "mesh")
        hess = gather_rows(result.hessian, mesh, "mesh")
        if rank == 0:
            out.update(_prefixed(i, dict(
                poses=pose, hessians=hess, seconds=seconds,
                seconds_max=slowest, syncs=int(syncs),
                captures=int(summed[0]), later_captures=int(summed[1]),
                pool_bytes=_pool("match_hypotheses_jit"),
                **{f"launches_{n}": int(c)
                   for n, c in zip(KERNELS, summed[2:])})))
    if rank == 0:
        _save(out_path, out)


def mesh_job(rank, world_size, out_path):
    """Four ranks' meshes: ``make_mesh(robot_axis=2)`` over every rank and
    ``make_mesh(2)`` over the first two. Writes each rank's (row, column,
    the sum of the ranks of its beam group, of its mesh) in each mesh,
    all-reduced over the groups (-1 where a rank is outside the mesh)."""
    full = make_mesh(robot_axis=2)
    part = make_mesh(2)
    me = torch.tensor([rank])
    place = [full.row, full.column, int(psum(me, full.beam_group)),
             int(psum(me, full.group))]
    place += ([-1] * 4 if part is None else
              [part.row, part.column, int(psum(me, part.beam_group)),
               int(psum(me, part.group))])
    places = gather_rows(torch.tensor([place]), full, "mesh")
    if rank == 0:
        _save(out_path, dict(places=places,
                             shapes=[full.robot, full.beam, part.robot,
                                     part.beam]))


def run_jobs(rank, world_size, jobs):
    """Runs each ``(job, args)`` of ``jobs`` in turn on the same ranks (one
    start of the ranks for several jobs)."""
    for job, args in jobs:
        job(rank, world_size, *args)


def stall_job(rank, world_size, seconds):
    """Rank 0 waits in an all-reduce that the other ranks join only after
    ``seconds``: a collective that hangs, for ``run_ranks``' deadline."""
    if rank:
        time.sleep(seconds)
    torch.distributed.all_reduce(torch.zeros(1))


def stacked_scans(scans) -> dict:
    """The points/origo/mask inputs of a job from per-step ``Scan``s (any
    device) with a leading robot axis."""
    return {f: np.stack([getattr(sc, f).cpu().numpy() for sc in scans])
            for f in Scan._fields}


# ---- the card modes -------------------------------------------------------

def corridor_fleet(steps: int, robots: int = ROBOTS):
    """Ranges f32[T, R, 1081] of ``robots`` robots, each on its own
    corridor trajectory (start 0-6.75 m along the corridor, 0.05-0.12 m
    per scan, its own noise seed), and each robot's true poses
    f32[T, R, 3]."""
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.io.simulator import (World,
                                                    corridor_trajectory,
                                                    simulate_trajectory)
    world = World.corridor(length=18.0, width=3.0)
    ranges, truth = [], []
    for r in range(robots):
        advance = 0.05 + 0.07 * ((r * 37) % robots) / (robots - 1)
        poses = corridor_trajectory(steps, advance=advance, weave=0.03)
        poses[:, 0] += 0.45 * (r % 16)
        truth.append(poses)
        ranges.append(simulate_trajectory(world, poses, ht.LaserModel(),
                                          range_noise_std=0.005,
                                          seed=100 + r))
    return np.stack(ranges, 1), np.stack(truth, 1)


def _job_inputs(cfg, ranges) -> dict:
    """A job's scan inputs from ranges f32[T, R, 1081], built on the CPU."""
    import hector_slam_tpu_torch as ht
    laser = ht.LaserModel()
    return stacked_scans([ht.stack_scans([ht.scan_from_ranges(
        rg, cfg.map.level_scale(0), laser, cfg.max_beams, device="cpu")
        for rg in ranges_t]) for ranges_t in ranges])


def _robots(inputs: dict, r: int) -> dict:
    return {k: (v[:r] if k == "start_poses" else v[:, :r])
            for k, v in inputs.items()}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _run(jobs, ranks, paths, device):
    """Runs the jobs on ``ranks`` ranks, NCCL for the card's tensors, gloo
    for the CPU's; returns each job's output (``paths``: name -> the npz
    a job writes) and the wall seconds."""
    from hector_slam_tpu_torch.parallel.sharded import run_ranks
    t0 = time.perf_counter()
    run_ranks(run_jobs, ranks, "gloo" if device == "cpu" else "nccl",
              (jobs,), deadline_s=DEADLINE_S)
    wall = time.perf_counter() - t0
    return {k: dict(np.load(p)) for k, p in paths.items()}, wall


def _rate(got, i, robots, steps):
    t = turn(got, i)
    return (steps - 1) * robots / float(t["seconds_max"])


def scaling(device: str = "cuda") -> dict:
    """Robot-scans/s of both fleets at 1, 2 and 4 NCCL ranks (up to the
    card count), 16 robots a rank, in turns (TURNS), and the weak-scaling
    efficiency of the compiled turns' mean rate. ``device``: the ranks'
    ("cpu" rehearses the run on gloo ranks)."""
    from hector_slam_tpu_torch.config import BENCH_CONFIG as cfg
    fleet_all = _job_inputs(cfg, corridor_fleet(SCALING_STEPS)[0])
    ref = np.load(SHARED_REFERENCE)
    shared_all = dict(_job_inputs(cfg, ref["ranges"][:SCALING_STEPS]),
                      start_poses=ref["start_poses"])
    sizes = [n for n in (1, 2, 4) if device == "cpu"
             or n <= torch.cuda.device_count()]
    rows, base = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in sizes:
            r = ROBOTS_PER_RANK * n
            paths = {k: str(Path(tmp) / f"{k}{n}.npz")
                     for k in ("fleet", "shared")}
            _log(f"scaling: {n} ranks, {r} robots")
            got, wall = _run([
                (fleet_job, (cfg, device, n, _robots(fleet_all, r),
                             paths["fleet"], TURNS)),
                (shared_fleet_job, (cfg, device, n, _robots(shared_all, r),
                                    paths["shared"], TURNS))], n, paths,
                device)
            row = {"ranks": n, "robots": r, "wall_s": wall}
            for name, g in got.items():
                turns = [turn(g, i) for i in range(len(TURNS))]
                rates = {rt: [_rate(g, i, r, SCALING_STEPS)
                              for i in range(len(TURNS)) if TURNS[i] == rt]
                         for rt in ("step", "eager")}
                means = {rt: sum(v) / len(v) for rt, v in rates.items()}
                for rt, m in means.items():
                    base.setdefault((name, rt), m)
                row[name] = dict(
                    graphed_robot_scans_per_s=rates["step"],
                    eager_robot_scans_per_s=rates["eager"],
                    efficiency=means["step"] / (base[name, "step"] * n),
                    eager_efficiency=means["eager"]
                    / (base[name, "eager"] * n),
                    captures=[int(t["captures"]) for t in turns],
                    syncs_last_step=[int(t["syncs"]) for t in turns],
                    paint_launches=[int(t["launches_raster_paint"])
                                    for t in turns],
                    pool_bytes=int(g["pool_bytes"]))
            rows.append(row)
    return {"mode": "scaling", "steps": SCALING_STEPS, "timed_steps":
            SCALING_STEPS - 1, "robots_per_rank": ROBOTS_PER_RANK,
            "turns": list(TURNS), "rows": rows,
            "rate": "robot-scans/s over the timed steps on the slowest "
                    "rank's host clock; efficiency: the compiled turns' "
                    "mean rate at n ranks / (n x that at 1 rank)"}


def _unsharded(cfg, fleet_in, shared_in, dev):
    """The same runs unsharded through the ``*_jit`` entry points in this
    process, and the hypotheses' inputs: B = 4096 poses around robot 0's
    final pose on the shared fleet's final map, with its last scan."""
    import hector_slam_tpu_torch as ht

    def steps(step, state, inputs):
        poses, gates, trunc = [], [], []
        for sc in _scans(inputs, dev):
            state, m = step(state, sc)
            poses.append(state.pose.clone())
            gates.append(m.map_updated)
            trunc.append(m.truncated_free_cells)
        return dict(poses=torch.stack(poses).cpu().numpy(),
                    gates=torch.stack(gates).cpu().numpy(),
                    truncated=torch.stack(trunc).cpu().numpy(),
                    count=state.map_update_count.cpu().numpy(),
                    **{f"lo_{k}": lo.cpu().numpy()
                       for k, lo in enumerate(state.log_odds)}), state

    r = fleet_in["mask"].shape[1]
    fleet, _ = steps(lambda st, sc: ht.fleet_step_jit(st, sc, cfg),
                     ht.init_fleet(cfg, r, device=dev), fleet_in)
    shared, state = steps(
        lambda st, sc: ht.shared_fleet_step_jit(st, sc, cfg),
        ht.init_shared_fleet(cfg, shared_in["mask"].shape[1],
                             start_poses=shared_in["start_poses"],
                             device=dev), shared_in)
    rng = np.random.default_rng(0)
    hyp_in = dict(levels=[lo.cpu().numpy() for lo in state.log_odds],
                  hypotheses=(shared["poses"][-1, 0] + rng.normal(
                      0, 0.05, (HYPOTHESES, 3))).astype(np.float32),
                  **{k: v[-1, 0] for k, v in shared_in.items()
                     if k != "start_poses"})
    hyp = ht.match_hypotheses_jit(
        [torch.from_numpy(lo).to(dev) for lo in hyp_in["levels"]],
        torch.from_numpy(hyp_in["hypotheses"]).to(dev),
        scan_from_numpy(hyp_in["points"], hyp_in["origo"], hyp_in["mask"],
                        dev), cfg).pose.cpu().numpy()
    del state
    graphs.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return fleet, shared, hyp_in, hyp


def four_cards(device: str = "cuda") -> dict:
    """The four-card run of the module docstring. ``device``: the ranks'
    ("cpu" rehearses it on four gloo ranks)."""
    from hector_slam_tpu_torch.config import BENCH_CONFIG as cfg
    if device != "cpu" and torch.cuda.device_count() < 4:
        raise RuntimeError(f"four_cards: {torch.cuda.device_count()} "
                           f"cards, four needed")
    dev = torch.device(device, 0) if device != "cpu" else torch.device("cpu")
    fleet_in = _job_inputs(cfg, corridor_fleet(CHECK_STEPS)[0])
    ref = np.load(SHARED_REFERENCE)
    shared_in = dict(_job_inputs(cfg, ref["ranges"][:CHECK_STEPS]),
                     start_poses=ref["start_poses"])
    _log("four_cards: inputs built")
    fleet, shared, hyp_in, hyp = _unsharded(cfg, fleet_in, shared_in, dev)
    _log("four_cards: the unsharded runs done; starting four ranks")
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: str(Path(tmp) / f"{k}.npz") for k in (
            "fleet_4x1", "fleet_2x2", "shared", "hypotheses")}
        got, wall = _run([
            (fleet_job, (cfg, device, 4, fleet_in, paths["fleet_4x1"],
                         TURNS)),
            (fleet_job, (cfg, device, 2, fleet_in, paths["fleet_2x2"],
                         ("step",))),
            (shared_fleet_job, (cfg, device, 4, shared_in, paths["shared"],
                                TURNS)),
            (hypotheses_job, (cfg, device, 4, hyp_in, paths["hypotheses"],
                              ("step", "eager")))], 4, paths, device)
    _log(f"four_cards: the ranks done in {wall:.2f} s")

    def bit_equal(g, want, keys):
        return all(np.array_equal(g[k], want[k]) for k in keys)

    levels = [f"lo_{k}" for k in range(cfg.map.levels)]
    keys = ["poses", "gates", "truncated", "count"] + levels
    f41, f22, sh, hy = (got[k] for k in ("fleet_4x1", "fleet_2x2", "shared",
                                         "hypotheses"))
    compiled = [i for i, rt in enumerate(TURNS) if rt == "step"]
    agree = float(np.mean(f22["lo_0"] == fleet["lo_0"]))
    steps = CHECK_STEPS
    checks = {
        "fleet_4x1_bit_equal": all(bit_equal(turn(f41, i), fleet, keys)
                                   for i in range(len(TURNS))),
        "fleet_2x2_poses": float(np.abs(f22["poses"] - fleet["poses"]).max())
        <= POSE_M,
        "fleet_2x2_gates": bool(np.array_equal(f22["gates"], fleet["gates"])),
        "fleet_2x2_maps": agree > MAP_AGREE,
        "shared_bit_equal": all(bit_equal(turn(sh, i), shared, keys)
                                for i in range(len(TURNS))),
        "hypotheses": float(np.abs(hy["poses"] - hyp).max()) <= HYP_M
        and float(np.abs(turn(hy, 1)["poses"] - hyp).max()) <= HYP_M,
        # one capture a rank in the first compiled turn, none after
        "captures": [int(turn(g, i)["captures"]) for g in (f41, sh)
                     for i in compiled] == [4, 0, 4, 0]
        and int(f22["captures"]) == 4 and int(hy["captures"]) == 4
        and int(hy["later_captures"]) == 0,
        "no_sync_in_a_replay": all(int(turn(g, i)["syncs"]) == 0
                                   for g in (f41, sh) for i in compiled)
        and int(f22["syncs"]) == 0 and int(hy["syncs"]) == 0,
        # one paint a rank and step, and one in each capture's warm-up
        "paint_launches": all(
            int(turn(g, i)["launches_raster_paint"])
            == 4 * steps + int(turn(g, i)["captures"])
            for g in (f41, f22, sh) for i in (compiled if g is not f22
                                              else [0])),
    }
    return {"mode": "four_cards", "ok": all(checks.values()),
            "checks": checks, "steps": steps, "timed_steps": steps - 1,
            "robots": int(fleet_in["mask"].shape[1]),
            "hypotheses": HYPOTHESES, "wall_s": wall, "turns": list(TURNS),
            "fleet_4x1_robot_scans_per_s": [
                _rate(f41, i, ROBOTS, steps) for i in range(len(TURNS))],
            "fleet_2x2_robot_scans_per_s": _rate(f22, 0, ROBOTS, steps),
            "shared_robot_scans_per_s": [
                _rate(sh, i, ROBOTS, steps) for i in range(len(TURNS))],
            "hypotheses_ms": {"step": float(hy["seconds_max"]) * 1e3,
                              "eager": float(turn(hy, 1)["seconds_max"])
                              * 1e3},
            "fleet_2x2_pose_max_diff_m": float(
                np.abs(f22["poses"] - fleet["poses"]).max()),
            "fleet_2x2_map_agreement": agree,
            "hypotheses_max_diff": float(np.abs(hy["poses"] - hyp).max()),
            "pool_bytes_per_rank": {
                "fleet_4x1": int(f41["pool_bytes"]),
                "fleet_2x2": int(f22["pool_bytes"]),
                "shared": int(sh["pool_bytes"]),
                "hypotheses": int(hy["pool_bytes"])},
            "gates_per_step": {"fleet": fleet["gates"].sum(1).tolist(),
                               "shared": shared["gates"].sum(1).tolist()}}


def main(argv) -> int:
    modes = {"scaling": scaling, "four_cards": four_cards}
    if not argv or not set(argv) <= set(modes):
        print(f"usage: python tools/torch_sharded_ranks.py "
              f"{{{'|'.join(modes)}}} ...", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_sharded_ranks: no CUDA device", file=sys.stderr)
        return 2
    ok = True
    for mode in argv:
        result = modes[mode]()
        print(json.dumps(result), flush=True)
        ok = ok and result.get("ok", True)
    print(_card(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
