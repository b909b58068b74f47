"""The plain reference of a fleet mapping into ONE shared map, and its
judge: the shared map's semantics in plain torch, followed along the
program's own path.

Semantics (those of ``hector_slam_tpu/parallel/shared_map.py``): at each
tick every robot matches its scan against the one shared map and decides
its own gate (``slam_ref.gates``); the gated robots' free and occupied
cell sets are OR-ed, occupied winning over free across robots as it wins
across beams, and the union is applied to the map's log-odds once, on
ticks where some robot's gate fired (the any-gate). ``slam_ref.update``
of several scans into one map is that union (``union_update`` below).

Judged along the program's path, as ``judge.follow`` judges one robot:
tick t's R scans are matched from the program's poses of tick t-1 (at
tick 0, from the robots' starts) on the reference's shared map, rebuilt
from the inputs and the program's earlier poses. Ticks up to and
including the next map write see one map and are matched as one batch.
The numbers are ``judge``'s: the widest pose and heading gaps over every
robot's every answer, the gates that differ from the reference's, the
shared map's cells off by more than ``judge.MAP_TOL`` at the end, and
the answers that are not finite.

Imports nothing of the program or of the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from . import judge, slam_ref


def union_update(p: slam_ref.Params, maps: Sequence[torch.Tensor],
                 gated: torch.Tensor, poses: torch.Tensor,
                 points: torch.Tensor, origo: torch.Tensor,
                 mask: torch.Tensor) -> None:
    """One tick's write into the shared levels [1, H, W], in place: the
    union of the gated robots' (bool [R]) scans at their poses [R, 3]
    (points [R, N, 2], origo [R, 2], mask [R, N]), applied once."""
    idx = torch.nonzero(gated.to(poses.device)).reshape(-1)
    slam_ref.update(p, maps, torch.zeros_like(idx), poses[idx],
                    points[idx], origo[idx], mask[idx])


def follow_shared(p: slam_ref.Params, poses: torch.Tensor,
                  starts: torch.Tensor, scan_at: Callable[[int], tuple],
                  device, dtype=torch.float64, gate_dtype=torch.float32):
    """The reference along the program's path of a shared-map fleet.
    ``poses`` [T, R, 3]: the program's poses after every tick;
    ``starts`` [R, 3]: the robots' start poses; ``scan_at(t)`` ->
    (points [R, N, 2], origo [R, 2], mask [R, N]) of tick t in
    finest-level map units. Returns (reference poses [T, R, 3] on the
    host, its gates [T, R], its final shared levels [1, H, W])."""
    t_count, r_count = poses.shape[:2]
    gate = slam_ref.gates(p, poses, gate_dtype)
    written = gate.any(1)
    maps = slam_ref.init_maps(p, 1, device, dtype)
    probs = [slam_ref.probabilities(m) for m in maps]
    begin = torch.cat([starts.to(poses.dtype)[None], poses[:-1]]
                      ).to(device, dtype)
    path = poses.to(device, dtype)
    out = torch.empty((t_count, r_count, 3), dtype=dtype, device=device)
    t = 0
    while t < t_count:
        end = t + 1
        while end < t_count and not bool(written[end - 1]):
            end += 1
        scans = [scan_at(i) for i in range(t, end)]
        n = (end - t) * r_count
        out[t:end] = slam_ref.match(
            p, probs, torch.zeros(n, dtype=torch.int64, device=device),
            begin[t:end].reshape(n, 3),
            torch.cat([s[0] for s in scans]).to(dtype),
            torch.cat([s[2] for s in scans])).reshape(end - t, r_count, 3)
        if bool(written[end - 1]):
            pts_u, org_u, mask_u = scans[-1]
            union_update(p, maps, gate[end - 1], path[end - 1],
                         pts_u.to(dtype), org_u.to(dtype), mask_u)
            for pr, m in zip(probs, maps):
                pr.copy_(slam_ref.probabilities(m))
        t = end
    return out.to(torch.float64).cpu(), gate, maps


def _cells_off(ours: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
               device) -> int:
    return int(sum(int(((a.to(device, torch.float64) - b.to(
        device, torch.float64)).abs() > judge.MAP_TOL).sum())
        for a, b in zip(ours, ref)))


def judge_shared(p: slam_ref.Params, poses: torch.Tensor,
                 starts: torch.Tensor, prog_gates: torch.Tensor,
                 prog_maps: Sequence[torch.Tensor], scan_at,
                 device) -> Dict[str, float]:
    """Every number of a shared-map fleet's path: the program's poses
    [T, R, 3], gates [T, R] and final shared levels (each [H, W] or
    [1, H, W]) held against ``follow_shared``'s reference. ``log``
    holds the gaps' quantiles for the run's notes."""
    ref, ref_gates, ref_maps = follow_shared(p, poses, starts, scan_at,
                                             device)
    nums = judge.pose_gaps(poses, ref)
    xy, th, _ = judge.gaps(poses, ref)
    nums["log"] = (f"xy gaps {judge.spread_of(xy)}; theta gaps "
                   f"{judge.spread_of(th)}")
    nums["gate_mismatches"] = int((prog_gates.cpu() != ref_gates).sum())
    nums["map_cells_off"] = _cells_off(
        [m.reshape(ref_m.shape) for m, ref_m in zip(prog_maps, ref_maps)],
        ref_maps, device)
    return nums


def control_shared(p: slam_ref.Params, poses: torch.Tensor,
                   starts: torch.Tensor, scan_at, device
                   ) -> Dict[str, float]:
    """The control: the reference in bfloat16 put in the program's place
    on the same path, judged against the float64 reference as the
    program is. Its numbers should fail."""
    low, low_gates, low_maps = follow_shared(p, poses, starts, scan_at,
                                             device, torch.bfloat16,
                                             torch.bfloat16)
    ref, ref_gates, ref_maps = follow_shared(p, poses, starts, scan_at,
                                             device)
    nums = judge.pose_gaps(low, ref)
    nums["gate_mismatches"] = int((low_gates != ref_gates).sum())
    nums["map_cells_off"] = _cells_off(low_maps, ref_maps, device)
    return nums

