"""Gauss-Newton scan matcher and coarse-to-fine pyramid matching.

Counterpart of ``hector_slam_tpu/core/matcher.py`` (matcher/ScanMatcher.h:
54-226 and the multi-map chain of slam_main/MapRepMultiMap.h:116-132).
A level of a single pose, or of robots with a scan each, is one launch of
the robot kernel (``ops/robot_match.py``: every GN step inside it; its
plain version on CPU tensors is the torch loop below). Hypotheses sharing
one scan, a beam-sharded scan and a traced match run the GN steps as a
Python loop of tensor ops. Neither makes a host sync: the guard, clamp
and empty-scan rule are selects on the device.

Replicated discrete behaviours:
  - (maxIterations + 1) GN steps (ScanMatcher.h:74,94)
  - solve guard H(0,0)!=0 && H(1,1)!=0 (ScanMatcher.h:201): a failed
    guard leaves the estimate unchanged but keeps the fresh H
  - dtheta clamp to +-0.2 rad per step (ScanMatcher.h:209-215)
  - final angle normalization (ScanMatcher.h:170)
  - finest level 5(+1) iterations, coarser 3(+1), pose chained coarse ->
    fine in world coords, scan scaled by 2^-level
  - an empty scan returns the input pose unchanged (ScanMatcher.h:68,189)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import SlamConfig
from ..types import MatchResult, Scan
from ..ops.robot_match import robot_match_level
from ..ops.solve3 import solve3
from .grid import map_to_world_pose, normalize_angle, world_to_map_pose
from .cell_models import prob_grid
from .collectives import por, psum, single_rank
from .interp import hessian_derivs_quad, quad_pack

_CLAMP = 0.2   # clamp casts it to f32, the JAX np.float32(0.2)


def guarded_step(estimate: torch.Tensor, hess: torch.Tensor,
                 dtr: torch.Tensor) -> torch.Tensor:
    """Solve, clamp and guard one GN update for [..., 3] estimates
    (ScanMatcher.h:201-215). The identity stands in for H where the guard
    fails so the solve stays finite; its result is discarded."""
    guard = (hess[..., 0, 0] != 0.0) & (hess[..., 1, 1] != 0.0)
    eye = torch.eye(3, dtype=hess.dtype, device=hess.device)
    safe_h = torch.where(guard[..., None, None], hess, eye)
    search = solve3(safe_h, dtr)
    search = torch.cat([search[..., :2],
                        torch.clamp(search[..., 2:], -_CLAMP, _CLAMP)], -1)
    return torch.where(guard[..., None], estimate + search, estimate)


def gn_step(
    quad: torch.Tensor,          # f32[H*W, 4] quad-packed prob grid
    shape: Tuple[int, int],
    estimate_map: torch.Tensor,  # f32[3]
    points: torch.Tensor,
    mask: torch.Tensor,
    beam_axis=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One estimateTransformationLogLh step (ScanMatcher.h:194-226).

    ``beam_axis``: the process group over which the scan's beams are
    sharded (None: unsharded). Each rank's partial H and dTr are summed
    over it (one all-reduce) before the solve, so every rank of the group
    takes the same step (hector_slam_tpu/core/matcher.py:60-62)."""
    hess, dtr = hessian_derivs_quad(quad, shape, estimate_map, points, mask)
    if beam_axis is not None:
        lead = hess.shape[:-2]
        moments = psum(torch.cat([hess.reshape(lead + (9,)), dtr], -1),
                       beam_axis)
        hess = moments[..., :9].reshape(lead + (3, 3))
        dtr = moments[..., 9:]
    return guarded_step(estimate_map, hess, dtr), hess


def finish_level(estimate: torch.Tensor, offset, cell_length):
    """Normalize the angle and return to world coords (ScanMatcher.h:170)."""
    estimate = torch.cat([estimate[..., :2],
                          normalize_angle(estimate[..., 2:])], -1)
    return map_to_world_pose(estimate, offset, cell_length)


def robot_route(pose: torch.Tensor, points: torch.Tensor, beam_axis,
                trace) -> bool:
    """Whether a level runs as one launch of the robot kernel: a single
    pose (f32[3]) or one scan a pose (``points`` [R, N, 2]), the beams not
    sharded over a group of more than one rank (each GN step would need
    its all-reduce), and no trace (it needs every step's H). Hypotheses
    sharing one scan take the torch loop."""
    return trace is None and single_rank(beam_axis) and (
        pose.dim() == 1 or points.dim() == 3)


def match_level(
    quad: torch.Tensor,
    shape: Tuple[int, int],
    begin_estimate_world: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
    iterations: int,
    offset,
    scale,
    cell_length,
    beam_axis=None,
    trace: list | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ScanMatcher::matchData on one pyramid level; iterations+1 GN steps
    (ScanMatcher.h:74,94). Poses f32[3] or f32[B, 3]; the scan is shared
    (points [N, 2], mask [N]) or one per pose ([B, N, 2], [B, N]), and
    ``quad`` is one grid [H*W, 4] or one per pose [B, H*W, 4].
    ``beam_axis``: as in ``gn_step``; a scan is empty when no rank of the
    group holds a valid beam. ``trace``: a list that gets every GN step's
    H (core/debug.py). A level that ``robot_route`` takes is one
    ``robot_match_level`` launch (a single pose as a batch of one); the
    rest run ``gn_step`` in a loop."""
    estimate = world_to_map_pose(begin_estimate_world, offset, scale)
    if robot_route(begin_estimate_world, points, beam_axis, trace):
        est, hess = robot_match_level(
            quad.contiguous(), shape, estimate.reshape(-1, 3).contiguous(),
            points.reshape((-1,) + points.shape[-2:]).contiguous(),
            mask.reshape((-1, mask.shape[-1])).contiguous(), iterations + 1)
        estimate = est.reshape(estimate.shape)
        hess = hess.reshape(estimate.shape[:-1] + (3, 3))
    else:
        for _ in range(iterations + 1):
            estimate, hess = gn_step(quad, shape, estimate, points, mask,
                                     beam_axis)
            if trace is not None:
                trace.append(hess)
    world = finish_level(estimate, offset, cell_length)
    # empty scan: the input pose verbatim (ScanMatcher.h:68,189), per
    # robot when each pose has its own scan
    [any_valid] = por([mask.any(-1)[..., None]], beam_axis)
    world = torch.where(any_valid, world, begin_estimate_world)
    hess = torch.where(any_valid[..., None], hess, torch.zeros_like(hess))
    return world, hess


def level_points(points: torch.Tensor, level: int) -> torch.Tensor:
    """The scan as a coarser level sees it: scaled by 2^-level
    (DataPointContainer.h:46-58)."""
    return points * (1.0 / (2.0 ** level)) if level > 0 else points


def level_quad(log_odds_pyramid, quads, level: int, model: str):
    """The level's quad-packed prob grid: the cached epoch view when
    given, else derived from the storage."""
    if quads is not None and len(quads) > level:
        return quads[level]
    return quad_pack(prob_grid(log_odds_pyramid[level], model))


def match_pyramid(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_estimate_world: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    quads: Sequence[torch.Tensor] | None = None,
    beam_axis=None,
    trace: list | None = None,
) -> MatchResult:
    """MapRepMultiMap::matchData (MapRepMultiMap.h:116-132): coarse->fine,
    pose chained in world coords; the returned H is the finest level's.
    ``quads``: optional per-level quad-packed prob grids
    (SlamState.quads, the epoch cache).

    Batched forms: B hypotheses f32[B, 3] against one map and one scan,
    or R robots f32[R, 3], each with its own scan (points [R, N, 2], mask
    [R, N]) and, given per-robot pyramids ([R, H, W] levels, quads
    [R, H*W, 4]), its own map. ``beam_axis``: the process group over
    which the scans' beams are sharded (``gn_step``). ``trace``: a list
    that gets every GN step's H, coarse to fine (``match_level``)."""
    mcfg = cfg.map
    pose = begin_estimate_world
    hess = None
    for level in range(mcfg.levels - 1, -1, -1):
        iters = (cfg.match.iterations_finest if level == 0
                 else cfg.match.iterations_coarse)
        pose, hess = match_level(
            level_quad(log_odds_pyramid, quads, level,
                       cfg.update.cell_model),
            tuple(log_odds_pyramid[level].shape[-2:]), pose,
            level_points(scan.points, level), scan.mask, iters,
            mcfg.top_left_offset, mcfg.level_scale(level),
            mcfg.level_resolution(level), beam_axis, trace)
    return MatchResult(pose=pose, hessian=hess)
