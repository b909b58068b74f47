"""What decides ``correct``: the program's outputs held against the plain
reference (``slam_ref``), step by step along the program's own path.

A SLAM step's answer is a pose and a gate, and the map it leaves. The
reference follows the program the way a served model's reference follows
its served tokens: for scan t of robot r it rebuilds the map from the
inputs and the program's poses of scans before t (with the gates it
decides itself from those poses), matches scan t from the program's pose
of scan t-1 (the node's default start estimate), and compares its pose
with the program's pose of scan t. So every answer is judged on its own;
an error does not carry on into later answers, and nothing the program
made but its answers is read. The map the program holds at the end is
compared with the reference's rebuilt map cell by cell.

Numbers (each beside its limit in ``benchmark/limits/<cell>.json``):
  - ``pose_gap_m``: the widest distance between a program pose and the
    reference's, over every checked answer;
  - ``theta_gap_rad``: the widest heading gap, likewise;
  - ``gate_mismatches``: answers whose gate differs from the reference's
    gate on the program's poses (exact: the gate is the C++'s f32 test);
  - ``map_cells_off``: map cells, over every level and robot, whose
    log-odds differ from the reference's by more than ``MAP_TOL``
    (a painting difference moves a cell by 0.405 or more; f32 sums of
    the same deltas stay within 1e-3);
  - ``non_finite``: answers with a non-finite pose.

Hypotheses matched from scattered starts (``hypothesis_gaps``) are
judged each against the reference's match from the same start. Most end
near the true pose; a few sit where two basins meet, and there float32
and float64 may end in different ones, centimetres apart, wherever the
reference ended:
  - ``pose_gap_p99_m`` / ``theta_gap_p99_rad``: the 99th percentile of
    the gaps over every judged hypothesis;
  - ``poses_off_pct``: the share (%) of the judged hypotheses that end
    more than ``OFF_M`` from the reference's answer, so that a fault in
    a few of every thousand fails.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from . import slam_ref

MAP_TOL = 0.01
CONVERGED_M = 0.01     # the reference's answer this near the true pose
OFF_M = 0.02           # an answer this far from the reference's is off


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


def gaps(ours: torch.Tensor, ref: torch.Tensor):
    """Position and heading gaps [...] between poses [..., 3], and which
    of ours are not finite (their gaps read 0)."""
    ours = ours.to(torch.float64)
    ref = ref.to(torch.float64)
    bad = ~torch.isfinite(ours).all(-1)
    xy = torch.linalg.vector_norm(ours[..., :2] - ref[..., :2], dim=-1)
    th = _wrap(ours[..., 2] - ref[..., 2]).abs()
    return (torch.where(bad, 0.0, xy), torch.where(bad, 0.0, th), bad)


def spread_of(x: torch.Tensor) -> str:
    """The gaps' quantiles, for the run's log."""
    q = torch.quantile(x.reshape(-1).double()[:2 ** 24],
                       torch.tensor([0.5, 0.9, 0.99, 0.999],
                                    dtype=torch.float64))
    return (f"p50 {q[0]:.3e} p90 {q[1]:.3e} p99 {q[2]:.3e} "
            f"p99.9 {q[3]:.3e} max {float(x.max()):.3e}")


def pose_gaps(ours: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """Widest position and heading gaps between poses [..., 3]."""
    xy, th, bad = gaps(ours, ref)
    return {"pose_gap_m": float(xy.max()), "theta_gap_rad": float(th.max()),
            "non_finite": int(bad.sum())}


def hypothesis_gaps(ours: torch.Tensor,
                    ref: torch.Tensor) -> Dict[str, float]:
    """The numbers of hypotheses' poses [..., 3] against the reference's
    from the same starts."""
    xy, th, bad = gaps(ours, ref)
    q = torch.tensor(0.99, dtype=torch.float64)
    return {"pose_gap_p99_m": float(torch.quantile(xy.reshape(-1), q)),
            "theta_gap_p99_rad": float(torch.quantile(th.reshape(-1), q)),
            "poses_off_pct": 100.0 * float((xy > OFF_M).double().mean()),
            "non_finite": int(bad.sum())}


def follow(p: slam_ref.Params, poses: torch.Tensor,
           scan_at: Callable[[int], tuple], device, dtype=torch.float64,
           gate_dtype=torch.float32):
    """The reference along the program's path of one robot. ``poses``
    [T, 1, 3]: the program's pose after every scan, from zero;
    ``scan_at(t)`` -> (points [1, N, 2], origo [1, 2], mask [1, N]) in
    finest-level map units. Returns (reference poses [T, 1, 3] on the
    host, its gates [T, 1], its final maps [1, H, W] per level). The
    scans up to and including the next update see one map and are
    matched as one batch."""
    t_count = poses.shape[0]
    gate = slam_ref.gates(p, poses, gate_dtype)
    maps = slam_ref.init_maps(p, 1, device, dtype)
    probs = [slam_ref.probabilities(m) for m in maps]
    starts = torch.cat([torch.zeros((1, 1, 3), dtype=poses.dtype),
                        poses[:-1]]).to(device, dtype)
    path = poses.to(device, dtype)
    out = torch.empty((t_count, 1, 3), dtype=dtype, device=device)
    which = torch.zeros(1, dtype=torch.int64, device=device)
    t = 0
    while t < t_count:
        end = t + 1
        while end < t_count and not bool(gate[end - 1, 0]):
            end += 1
        scans = [scan_at(i) for i in range(t, end)]
        out[t:end, 0] = slam_ref.match(
            p, probs, which.repeat(end - t), starts[t:end, 0],
            torch.cat([s[0] for s in scans]).to(dtype),
            torch.cat([s[2] for s in scans]))
        if bool(gate[end - 1, 0]):
            pts_u, org_u, mask_u = scans[-1]
            slam_ref.update(p, maps, which, path[end - 1],
                            pts_u.to(dtype), org_u.to(dtype), mask_u)
            for pr, m in zip(probs, maps):
                pr.copy_(slam_ref.probabilities(m))
        t = end
    return out.to(torch.float64).cpu(), gate, maps


def judge_path(p: slam_ref.Params, poses: torch.Tensor,
               prog_gates: Optional[torch.Tensor],
               prog_maps: Optional[Sequence[torch.Tensor]], scan_at, device):
    """Every number of a path: the program's poses [T, 1, 3], gates
    [T, 1] (or None) and final maps (per level [1, H, W], or None) held
    against ``follow``'s reference. Returns (numbers, reference maps)."""
    ref, ref_gates, ref_maps = follow(p, poses, scan_at, device)
    nums = pose_gaps(poses, ref)
    xy, th, _ = gaps(poses, ref)
    nums["log"] = f"xy gaps {spread_of(xy)}; theta gaps {spread_of(th)}"
    if prog_gates is not None:
        nums["gate_mismatches"] = int((prog_gates.cpu()
                                       != ref_gates).sum())
    if prog_maps is not None:
        nums["map_cells_off"] = int(sum(
            int(((a.to(device, torch.float64) - b.to(torch.float64)).abs()
                 > MAP_TOL).sum())
            for a, b in zip(prog_maps, ref_maps)))
    return nums, ref_maps


def control_path(p: slam_ref.Params, poses: torch.Tensor, scan_at, device):
    """The control: the reference in bfloat16 put in the program's place
    on the same path, judged against the float64 reference as the
    program is. Its numbers should fail."""
    low, low_gates, low_maps = follow(p, poses, scan_at, device,
                                      torch.bfloat16, torch.bfloat16)
    # the control's answer for scan t is its match from the program's
    # pose of scan t-1; judge it as the program's answer
    ref, ref_gates, ref_maps = follow(p, poses, scan_at, device)
    nums = pose_gaps(low, ref)
    nums["gate_mismatches"] = int((low_gates != ref_gates).sum())
    nums["map_cells_off"] = int(sum(
        int(((a.to(torch.float64) - b).abs() > MAP_TOL).sum())
        for a, b in zip(low_maps, ref_maps)))
    return nums
