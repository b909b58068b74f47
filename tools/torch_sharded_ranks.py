"""Rank jobs for the port's sharded steps
(``hector_slam_tpu_torch/parallel/sharded.py``), started by
``sharded.run_ranks``:

    run_ranks(fleet_job, 4, "gloo", (cfg, "cpu", 2, inputs, out_path))

``tests/test_torch_sharded.py`` runs them on gloo ranks on the CPU, and
``chip_smoke.py`` (phase ``sharded``) on four gloo ranks sharing one card
and on one NCCL rank. Each job takes its inputs whole, as numpy arrays:
every rank builds the whole state and keeps its block, runs the sharded
path, and the results are gathered to rank 0, which writes them to the
npz ``out_path`` with the launches of each CUDA kernel counted in the
ranks (summed over them) and rank 0's host seconds for the steps after
the first (the first, from empty maps, is a warm-up). Imports no JAX.

  - ``fleet_job``: the per-robot fleet (``make_fleet_step``), robots over
    the mesh's rows and beams over its columns;
  - ``shared_fleet_job``: the shared-map fleet
    (``make_shared_fleet_step``), robots over the whole mesh;
  - ``hypotheses_job``: ``shard_hypotheses``, the hypothesis axis over the
    whole mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hector_slam_tpu_torch.convert import (fleet_state_from_numpy,
                                           scan_from_numpy)
from hector_slam_tpu_torch.core.collectives import psum
from hector_slam_tpu_torch.ops import interp_moments, paint_cells
from hector_slam_tpu_torch.parallel.batch import init_fleet
from hector_slam_tpu_torch.parallel.shared_map import init_shared_fleet
from hector_slam_tpu_torch.parallel.sharded import (
    gather_fleet_state, gather_rows, gather_shared_fleet_state,
    make_fleet_step, make_mesh, make_shared_fleet_step, shard_fleet_state,
    shard_hypotheses, shard_scan, shard_shared_fleet_scan,
    shard_shared_fleet_state)
from hector_slam_tpu_torch.types import Scan

KERNELS = {"interp_moments": interp_moments.interp_moments,
           "paint_cells": paint_cells.paint_cells}


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _steps(step, state, scans, device):
    """Runs ``step`` over the scans with the kernel counts set to 0 first.
    Returns (state, metrics per step, poses per step, seconds of the
    steps after the first, launches in this rank)."""
    for k in KERNELS.values():
        k.launches = 0
    metrics, poses, t0 = [], [], None
    for t, sc in enumerate(scans):
        state, m = step(state, sc)
        metrics.append(m)
        poses.append(state.pose)
        if t == 0:
            _sync(device)
            t0 = time.perf_counter()
    _sync(device)
    seconds = time.perf_counter() - t0
    return state, metrics, poses, seconds, {n: k.launches
                                            for n, k in KERNELS.items()}


def _launch_totals(launches, mesh, device):
    counts = torch.tensor([launches[n] for n in KERNELS], dtype=torch.int64,
                          device=device)
    return dict(zip(KERNELS, psum(counts, mesh.group).tolist()))


def _per_step(tensors, mesh, axis):
    """Per-step tensors [R_local, ...] gathered to rank 0 as [T, R, ...]."""
    full = gather_rows(torch.stack(tensors, 1), mesh, axis)
    return None if full is None else full.transpose(0, 1)


def _save(out_path, **fields) -> None:
    np.savez(out_path, **{k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v) for k, v in fields.items()})


def _scans(inputs, device):
    return [scan_from_numpy(inputs["points"][t], inputs["origo"][t],
                            inputs["mask"][t], device)
            for t in range(inputs["mask"].shape[0])]


def fleet_job(rank, world_size, cfg, device, robot_axis, inputs, out_path):
    """``inputs``: points [T, R, N, 2], origo [T, R, 2], mask [T, R, N],
    and optionally ``state``: the ``fleet_state_from_numpy`` arguments of
    the starting fleet (default: ``init_fleet``). Writes poses [T, R, 3],
    gates, truncated and valid-beam counts [T, R], the final levels
    ``lo_<k>`` [R, H, W] and update counts [R]."""
    mesh = make_mesh(robot_axis=robot_axis)
    r = inputs["mask"].shape[1]
    full = (fleet_state_from_numpy(*inputs["state"], cfg, device=device)
            if "state" in inputs else init_fleet(cfg, r, device=device))
    state = shard_fleet_state(full, mesh, cfg)
    del full
    scans = [shard_scan(sc, mesh) for sc in _scans(inputs, device)]
    state, metrics, poses, seconds, launches = _steps(
        make_fleet_step(mesh, cfg), state, scans, device)
    out = dict(
        poses=_per_step(poses, mesh, "robot"),
        gates=_per_step([m.map_updated for m in metrics], mesh, "robot"),
        truncated=_per_step([m.truncated_free_cells for m in metrics], mesh,
                            "robot"),
        num_valid=_per_step([m.num_valid_beams for m in metrics], mesh,
                            "robot"))
    final = gather_fleet_state(state, mesh)
    totals = _launch_totals(launches, mesh, device)
    if rank == 0:
        _save(out_path, **out, count=final.map_update_count,
              **{f"lo_{k}": lo for k, lo in enumerate(final.log_odds)},
              seconds=seconds, **{f"launches_{n}": c
                                  for n, c in totals.items()})


def shared_fleet_job(rank, world_size, cfg, device, robot_axis, inputs,
                     out_path):
    """``inputs``: points [T, R, N, 2], origo [T, R, 2], mask [T, R, N],
    start_poses [R, 3]. Writes poses [T, R, 3], gates and valid-beam
    counts [T, R], the fleet's truncated counts [T], the final levels
    ``lo_<k>`` [H, W] and the update count."""
    mesh = make_mesh(robot_axis=robot_axis)
    r = inputs["mask"].shape[1]
    full = init_shared_fleet(cfg, r, start_poses=inputs["start_poses"],
                             device=device)
    state = shard_shared_fleet_state(full, mesh, cfg)
    del full
    scans = [shard_shared_fleet_scan(sc, mesh)
             for sc in _scans(inputs, device)]
    state, metrics, poses, seconds, launches = _steps(
        make_shared_fleet_step(mesh, cfg), state, scans, device)
    out = dict(
        poses=_per_step(poses, mesh, "mesh"),
        gates=_per_step([m.map_updated for m in metrics], mesh, "mesh"),
        num_valid=_per_step([m.num_valid_beams for m in metrics], mesh,
                            "mesh"))
    final = gather_shared_fleet_state(state, mesh)
    totals = _launch_totals(launches, mesh, device)
    if rank == 0:
        _save(out_path, **out, truncated=torch.stack(
            [m.truncated_free_cells for m in metrics]),
            count=final.map_update_count,
            **{f"lo_{k}": lo for k, lo in enumerate(final.log_odds)},
            seconds=seconds, **{f"launches_{n}": c
                                for n, c in totals.items()})


def hypotheses_job(rank, world_size, cfg, device, robot_axis, inputs,
                   out_path):
    """``inputs``: levels (a list of [H, W] log-odds), hypotheses [H, 3],
    and the scan's points [N, 2], origo [2], mask [N]. Writes the matched
    poses [H, 3] and Hessians [H, 3, 3], and rank 0's seconds for one call
    after a first."""
    mesh = make_mesh(robot_axis=robot_axis)
    pyramid = [torch.from_numpy(np.asarray(lo, np.float32)).to(device)
               for lo in inputs["levels"]]
    hyps = torch.from_numpy(np.asarray(inputs["hypotheses"],
                                       np.float32)).to(device)
    scan = scan_from_numpy(inputs["points"], inputs["origo"], inputs["mask"],
                           device)
    fn = shard_hypotheses(mesh, cfg)
    for k in KERNELS.values():
        k.launches = 0
    fn(pyramid, hyps, scan)
    _sync(device)
    t0 = time.perf_counter()
    result = fn(pyramid, hyps, scan)
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = {n: k.launches for n, k in KERNELS.items()}
    pose = gather_rows(result.pose, mesh, "mesh")
    hess = gather_rows(result.hessian, mesh, "mesh")
    totals = _launch_totals(launches, mesh, device)
    if rank == 0:
        _save(out_path, poses=pose, hessians=hess, seconds=seconds,
              **{f"launches_{n}": c for n, c in totals.items()})


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
        _save(out_path, places=places,
              shapes=[full.robot, full.beam, part.robot, part.beam])


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
