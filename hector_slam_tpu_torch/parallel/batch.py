"""Batched execution on one card: multi-hypothesis matching and fleets of
robots with a map each.

Counterpart of ``hector_slam_tpu/parallel/batch.py``, whose ``vmap`` axes
become leading tensor axes here (BASELINE.json configs 4-5):
  - hypothesis axis H: many start poses matched against ONE map pyramid
    and one scan (``match_pyramid`` with poses [H, 3]);
  - robot axis R: independent trajectories, each with its own scan and
    map pyramid — a leading axis on every ``SlamState`` leaf.

``fleet_step`` runs the whole fleet as one batched step with no host
read: per-robot GN matching (each robot gathers from its own quads
through an int64 offset), per-robot gates, and one map update for the
fleet (one paint call for every cell set and level,
core/mapping.paint_pyramid). The JAX vmap turns the gate's ``lax.cond``
into a select; here the ungated robots' beams go to the sentinel and the
update writes only the gated robots' maps and quads
(core/mapping.integrate_sets), the gates read on the device.

The compiled entry points (``match_hypotheses_jit``,
``residual_for_poses_jit``, ``fleet_step_jit``) are CUDA graphs of these
bodies on the card (core/graphs.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import SlamConfig
from ..core import graphs
from ..core.collectives import psum
from ..core.grid import pose_difference_larger_than, world_to_map_pose
from ..core.interp import beam_sum, interp_quad, quad_pack_storage
from ..core.mapping import integrate_sets, paint_pyramid
from ..core.matcher import level_points, match_pyramid
from ..core.slam import compiled_step, init_state
from ..ops.solve3 import det3
from ..types import MatchResult, Scan, SlamState, StepMetrics


def match_hypotheses(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_poses: torch.Tensor,   # f32[H, 3] world poses
    scan: Scan,
    cfg: SlamConfig,
) -> MatchResult:
    """Matches H hypothesis poses against one shared map with the torch-op
    matcher (the plain path; ``match_hypotheses_kernel`` is the one through
    the moments kernel). Returns MatchResult with leading axis H."""
    return match_pyramid(log_odds_pyramid, begin_poses, scan, cfg)


def match_hypotheses_jit(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_poses: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
) -> MatchResult:
    """``match_hypotheses`` compiled (the JAX package's
    ``match_hypotheses_jit``, hector_slam_tpu/parallel/batch.py:42): on
    the card a CUDA graph captured once per (``cfg``, shapes, map memory)
    and replayed with no host round trip; the results are new tensors.
    On CPU tensors it runs eagerly."""
    if not graphs.on_card(begin_poses):
        return match_hypotheses(log_odds_pyramid, begin_poses, scan, cfg)
    return graphs.call(
        "match_hypotheses_jit", (cfg,), list(log_odds_pyramid),
        [begin_poses, *scan],
        lambda levels, statics: match_hypotheses(
            levels, statics[0], Scan(*statics[1:4]), cfg))


def residual_for_poses(
    log_odds: torch.Tensor,
    poses_world: torch.Tensor,   # f32[H, 3]
    scan: Scan,
    cfg: SlamConfig,
    quad: torch.Tensor | None = None,
    level: int = 0,
) -> torch.Tensor:
    """Map-match residual sum(1 - M) per pose on pyramid level ``level``
    (default: finest), the reference's getResidualForState
    (OccGridMapUtil.h:204-221), batched. ``log_odds`` is THAT level's
    grid; ``scan`` carries finest-level-scale points, scaled down here as
    the matcher does. ``quad``: optional pre-packed prob quads
    (SlamState.quads[level], the epoch cache). Returns f32[H]."""
    if quad is None:
        quad = quad_pack_storage(log_odds, cfg.update.cell_model)
    pm = world_to_map_pose(poses_world, cfg.map.top_left_offset,
                           cfg.map.level_scale(level))
    pts = level_points(scan.points, level)
    s = torch.sin(pm[..., 2:3])
    c = torch.cos(pm[..., 2:3])
    # Eigen affine order: m00*px + (m01*py + t) (see core/interp.py)
    tx = c * pts[:, 0] + (-s * pts[:, 1] + pm[..., 0:1])
    ty = s * pts[:, 0] + (c * pts[:, 1] + pm[..., 1:2])
    m, _, _ = interp_quad(quad, tuple(log_odds.shape[-2:]),
                          torch.stack([tx, ty], dim=-1))
    return beam_sum(torch.where(scan.mask, 1.0 - m, 0.0))


def residual_for_poses_jit(
    log_odds: torch.Tensor,
    poses_world: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    quad: torch.Tensor | None = None,
    level: int = 0,
) -> torch.Tensor:
    """``residual_for_poses`` compiled (the JAX package's
    ``residual_for_poses_jit``, hector_slam_tpu/parallel/batch.py:83-84,
    static ``cfg`` and ``level``): on the card a CUDA graph captured once
    per (``cfg``, ``level``, whether ``quad`` is given, shapes, the map's
    memory) and replayed with no host round trip; the residuals are a new
    tensor. On CPU tensors it runs eagerly.

    Unlike XLA, which frees a call's temporaries when it returns, the
    graph keeps them in its pool for as long as it lives: at the global
    sweep's 65,536 poses that is the ~1 GB of the interpolation's
    intermediates (PERF.md §7)."""
    if not graphs.on_card(poses_world):
        return residual_for_poses(log_odds, poses_world, scan, cfg, quad,
                                  level)
    held = [log_odds] if quad is None else [log_odds, quad]
    return graphs.call(
        "residual_for_poses_jit", (cfg, level, quad is not None), held,
        [poses_world, *scan],
        lambda maps, statics: residual_for_poses(
            maps[0], statics[0], Scan(*statics[1:4]), cfg,
            maps[1] if len(maps) > 1 else None, level))


def best_hypothesis(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_poses: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Match all hypotheses, score by finest-level residual, return
    (best_pose f32[3], best_hessian f32[3,3], residuals f32[H])."""
    result = match_hypotheses(log_odds_pyramid, begin_poses, scan, cfg)
    res = residual_for_poses(log_odds_pyramid[0], result.pose, scan, cfg)
    i = torch.argmin(res)
    return result.pose[i], result.hessian[i], res


def fleet_step(
    states: SlamState,   # leading robot axis R on every leaf
    scans: Scan,         # points [R, N, 2], origo [R, 2], mask [R, N]
    cfg: SlamConfig,
    beam_axis=None,
    *,
    in_place: bool = False,
) -> Tuple[SlamState, StepMetrics]:
    """One SLAM step for R independent robots: each robot matches its scan
    against its own map, gates on its own last update pose and, if gated,
    integrates into its own map — ``slam_step`` per robot, batched.
    Returns (new states, metrics with leading axis R).

    The cell sets are painted on every step with the ungated robots'
    beams masked, and the update writes the levels and quads of the
    robots whose gate fired and leaves the others' (JAX's vmapped
    ``lax.cond`` is this select), the gates read on the device.
    ``in_place``: written into the states' own maps (a donating step);
    otherwise the states are left as they were.

    ``beam_axis``: the process group over which the scans' beams are
    sharded (parallel/sharded.make_fleet_step): its ranks hold the same
    robots, combine each GN step's normal equations and the painted cell
    sets, and so take the same gates, as ``slam_step`` does; every rank
    of the group issues the same collectives on every step, gated or
    not."""
    result = match_pyramid(states.log_odds, states.pose, scans, cfg,
                           quads=states.quads, beam_axis=beam_axis)
    new_pose, hessian = result.pose, result.hessian
    gates = pose_difference_larger_than(
        new_pose, states.last_map_update_pose,
        cfg.map_update_distance_thresh, cfg.map_update_angle_thresh)
    sets, truncated = paint_pyramid(states.log_odds, new_pose, scans, cfg,
                                    beam_axis, gates=gates)
    new_log_odds, new_quads = integrate_sets(
        states.log_odds, states.quads, sets, gates, cfg, in_place)
    return _fleet_result(states, scans, new_pose, hessian, gates,
                         new_log_odds, new_quads,
                         psum(truncated, beam_axis), beam_axis)


def _fleet_result(states, scans, new_pose, hessian, gates, new_log_odds,
                  new_quads, truncated, beam_axis):
    new_states = SlamState(
        log_odds=new_log_odds,
        pose=new_pose,
        last_map_update_pose=torch.where(gates[:, None], new_pose,
                                         states.last_map_update_pose),
        covariance=hessian,
        step=states.step + 1,
        map_update_count=states.map_update_count + gates.to(torch.int32),
        quads=new_quads,
    )
    metrics = StepMetrics(
        pose_delta=new_pose - states.pose,
        map_updated=gates,
        hessian_det=det3(hessian),
        num_valid_beams=psum(scans.mask.sum(-1).to(torch.int32), beam_axis),
        truncated_free_cells=truncated,
    )
    return new_states, metrics


def fleet_step_jit(states: SlamState, scans: Scan, cfg: SlamConfig):
    """``fleet_step`` compiled (the JAX package's ``fleet_step_jit``,
    hector_slam_tpu/parallel/batch.py:119): on the card a CUDA graph
    captured once per (``cfg``, shapes, the fleet's map memory) and
    replayed with no host round trip. The states are
    DONATED, as JAX's are (see ``slam_step_jit``); the metrics are new
    tensors. On CPU tensors the body runs eagerly."""
    if not graphs.on_card(states.pose):
        return fleet_step(states, scans, cfg)
    return compiled_step(
        "fleet_step_jit", (cfg,), states, scans,
        lambda st, points, origo, mask, in_place: fleet_step(
            st, Scan(points, origo, mask), cfg, in_place=in_place))


def init_fleet(cfg: SlamConfig, num_robots: int,
               device="cuda") -> SlamState:
    """Fresh per-robot states stacked on a leading axis, on ``device``
    (the card unless the caller asks for the CPU). Every leaf is its own
    contiguous memory, so a robot's grids and quads are addressable at
    r*H*W."""
    one = init_state(cfg, device)

    def stack(x):
        return x.unsqueeze(0).expand((num_robots,) + x.shape).contiguous()

    return SlamState(*(tuple(stack(t) for t in leaf)
                       if isinstance(leaf, tuple) else stack(leaf)
                       for leaf in one))
