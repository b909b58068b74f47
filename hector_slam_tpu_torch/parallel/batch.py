"""Batched execution on one card: multi-hypothesis matching and fleets of
robots with a map each.

Counterpart of ``hector_slam_tpu/parallel/batch.py``, whose ``vmap`` axes
become leading tensor axes here (BASELINE.json configs 4-5):
  - hypothesis axis H: many start poses matched against ONE map pyramid
    and one scan (``match_pyramid`` with poses [H, 3]);
  - robot axis R: independent trajectories, each with its own scan and
    map pyramid — a leading axis on every ``SlamState`` leaf.

``fleet_step`` runs the whole fleet as one batched step: per-robot GN
matching (each robot gathers from its own quads through an int64 offset),
per-robot gates, and one map update for all gated robots (one paint call
for every cell set and level, core/mapping.update_pyramid). The JAX
vmap turns the gate's ``lax.cond`` into a select; here non-gated robots'
beams go to the sentinel, so their maps come out unchanged, and the one
host sync per step skips the update when no robot gated.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import SlamConfig
from ..core.grid import pose_difference_larger_than, world_to_map_pose
from ..core.interp import beam_sum, interp_quad, quad_pack_storage
from ..core.mapping import update_pyramid
from ..core.matcher import level_points, match_pyramid
from ..core.slam import init_state, quads_of
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
) -> Tuple[SlamState, StepMetrics]:
    """One SLAM step for R independent robots: each robot matches its scan
    against its own map, gates on its own last update pose and, if gated,
    integrates into its own map — ``slam_step`` per robot, batched.
    Returns (new states, metrics with leading axis R)."""
    result = match_pyramid(states.log_odds, states.pose, scans, cfg,
                           quads=states.quads)
    new_pose, hessian = result.pose, result.hessian
    gates = pose_difference_larger_than(
        new_pose, states.last_map_update_pose,
        cfg.map_update_distance_thresh, cfg.map_update_angle_thresh)
    if bool(gates.any()):   # the one host sync per step
        new_log_odds, truncated = update_pyramid(
            states.log_odds, new_pose, scans, cfg, gates)
        # non-gated robots' maps are unchanged, so their quads come out
        # as they were
        new_quads = quads_of(new_log_odds, cfg.update.cell_model)
    else:
        new_log_odds, new_quads = states.log_odds, states.quads
        truncated = torch.zeros(gates.shape, dtype=torch.int32,
                                device=gates.device)
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
        num_valid_beams=scans.mask.sum(-1).to(torch.int32),
        truncated_free_cells=truncated,
    )
    return new_states, metrics


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
