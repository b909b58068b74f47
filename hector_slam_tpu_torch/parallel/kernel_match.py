"""Batched multi-hypothesis pyramid matching through the moments kernel
(ops/interp_moments.py) — the path for relocalization, hypothesis
scoring and the bench workload (BASELINE config 4).

Counterpart of ``hector_slam_tpu/parallel/pallas_match.py:
match_hypotheses_pallas`` with the same contract: B world poses in, B
matched poses and finest-level Hessians out, the coarse-to-fine schedule
of core/matcher.py per hypothesis. What the TPU driver needed and this
one does not:
  - the static VMEM gate: every level goes through the kernel, whatever
    its size (the card's kernel reads the grid from L2/HBM, no windows);
  - the per-level theta sort: it only tightened VMEM windows, and
    per-hypothesis numerics do not depend on order;
  - hypothesis and beam padding: the kernel takes any B and N;
  - the window repair and budget fallback: no query leaves the kernel, so
    ``MatchDiag`` reports 0 slow, repaired and overflow counts.
Each pyramid level is ONE launch of the moments kernel's level form
(``interp_moments_level``): every GN step's moments, guard, solve, clamp
and pose update run inside it, bit-equal to ``gn_step_kernel`` applied
step by step. ``match_hypotheses_kernel_jit`` replays the whole matcher,
one kernel launch a level and the level transforms around them, as one
CUDA graph (core/graphs.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..config import SlamConfig
from ..types import MatchResult, Scan
from ..core import graphs
from ..core.grid import world_to_map_pose
from ..core.matcher import (finish_level, guarded_step, level_points,
                            level_quad)
from ..ops.interp_moments import interp_moments, interp_moments_level


class MatchDiag(NamedTuple):
    """Fast-path telemetry, fields as in the JAX driver. Query totals are
    f32 (they scale as hypotheses x beams x GN steps). Through the moments
    kernel no query leaves the fast path, so the counts other than the
    total are 0; the patch matcher (parallel/onehot_match.py) reports its
    repairs and overflowed steps."""

    repaired_queries: torch.Tensor   # i32[] left-out queries repaired
    overflow_steps: torch.Tensor     # i32[] GN steps past the repair budget
    total_queries: torch.Tensor      # f32[] hypothesis x beam x GN-step count
    slow_queries: torch.Tensor       # f32[] repaired + every query of an
    #                                  overflowed step

    def fast_path_fraction(self):
        tot = torch.clamp(self.total_queries, min=1.0)
        return 1.0 - self.slow_queries / tot


def gn_step_kernel(quad: torch.Tensor, shape: Tuple[int, int],
                   estimates_map: torch.Tensor, points: torch.Tensor,
                   mask: torch.Tensor):
    """One batched GN step (ScanMatcher.h:194-226 per hypothesis): kernel
    moments, then the guard, solve3 and dtheta clamp as torch ops
    (pallas_match.py:153-160). Returns (new_estimates f32[B,3],
    hess f32[B,3,3]). The per-step reference the level form
    (``interp_moments_level``) is held to."""
    mom = interp_moments(quad, shape, estimates_map, points, mask)
    return guarded_step(estimates_map, mom.hess, mom.dtr), mom.hess


def match_hypotheses_kernel(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_poses: torch.Tensor,   # f32[B, 3] world poses
    scan: Scan,
    cfg: SlamConfig,
    quads: Sequence[torch.Tensor] | None = None,
    max_level: int | None = None,
    min_level: int = 0,
) -> Tuple[MatchResult, MatchDiag]:
    """Batched pyramid matcher. ``quads``: optional per-level quad-packed
    prob grids (SlamState.quads, the epoch cache), used as they are.
    ``max_level``/``min_level`` restrict the schedule to a pyramid subset
    (defaults: the full pyramid). Returns (MatchResult with leading axis
    B, MatchDiag)."""
    mcfg = cfg.map
    dev = begin_poses.device
    if max_level is None:
        max_level = mcfg.levels - 1
    b = begin_poses.shape[0]
    n = scan.points.shape[0]
    mask = scan.mask.contiguous()
    any_valid = mask.any()
    poses = begin_poses
    hess = torch.zeros((b, 3, 3), dtype=torch.float32, device=dev)
    steps = 0
    for level in range(max_level, min_level - 1, -1):
        iters = (cfg.match.iterations_finest if level == 0
                 else cfg.match.iterations_coarse)
        shape = tuple(log_odds_pyramid[level].shape[-2:])
        quad = level_quad(log_odds_pyramid, quads, level,
                          cfg.update.cell_model).contiguous()
        pts = level_points(scan.points, level).contiguous()
        offset = mcfg.top_left_offset
        est = world_to_map_pose(poses, offset, mcfg.level_scale(level))
        est, hess = interp_moments_level(quad, shape, est, pts, mask,
                                         iters + 1)
        steps += iters + 1
        world = finish_level(est, offset, mcfg.level_resolution(level))
        poses = torch.where(any_valid, world, poses)
        hess = torch.where(any_valid, hess, torch.zeros_like(hess))
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    zf = torch.zeros((), dtype=torch.float32, device=dev)
    diag = MatchDiag(zi, zi, zf + float(b * n * steps), zf)
    return MatchResult(pose=poses, hessian=hess), diag


def match_hypotheses_kernel_jit(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_poses: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    quads: Sequence[torch.Tensor] | None = None,
    max_level: int | None = None,
    min_level: int = 0,
) -> Tuple[MatchResult, MatchDiag]:
    """``match_hypotheses_kernel`` compiled: the counterpart of the JAX
    package's ``match_hypotheses_pallas_jit``
    (hector_slam_tpu/parallel/pallas_match.py:303). On the card a CUDA graph
    of the whole matcher (one ``interp_moments_level`` launch a level and
    the level transforms around it), captured once per (``cfg``, levels,
    whether ``quads`` are given, shapes, the map's memory) and replayed
    with no host round trip; the results are new tensors. On CPU tensors it runs eagerly."""
    if not graphs.on_card(begin_poses):
        return match_hypotheses_kernel(log_odds_pyramid, begin_poses, scan,
                                       cfg, quads, max_level, min_level)
    levels = len(log_odds_pyramid)
    return graphs.call(
        "match_hypotheses_kernel_jit",
        (cfg, quads is not None, max_level, min_level),
        [*log_odds_pyramid, *(quads or ())], [begin_poses, *scan],
        lambda held, statics: match_hypotheses_kernel(
            held[:levels], statics[0], Scan(*statics[1:4]), cfg,
            held[levels:] or None, max_level, min_level))
