"""Recovery machinery for the batched relocalizers: coarse-level
hypothesis pruning and the cascaded refine through the moments kernel.

Counterpart of ``hector_slam_tpu/parallel/recovery.py``. Pruning scores
every hypothesis by its coarsest-level map residual (a beam-subsampled
scan) and keeps the best; the cascade refines all survivors on the
coarsest level only, keeps the best groups by the next finer level's
residual, and runs the fine levels on that clustered set. The scoring
rule is getResidualForState (OccGridMapUtil.h:204-221); the coarse-first
schedule is MapRepMultiMap::matchData (MapRepMultiMap.h:116-132).

On the TPU both stages existed to keep the VMEM kernel's windows from
overflowing; the card's kernel has no windows (``kernel_match.py``), so
JAX's ``wr`` (window height) has no counterpart. The selection rules are
kept as they are, because they decide which hypotheses survive.

Selections break ties as ``jax.lax.top_k(-scores, k)`` does: ascending
scores, equal scores by lower index, NaN after every number
(``_smallest``); ``torch.topk`` promises no order among ties.

``cascade_refine_jit`` replays the whole cascade, both matcher stages and
the selection between them, as one CUDA graph (core/graphs.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import SlamConfig
from ..core import graphs
from ..types import Scan
from .batch import residual_for_poses
from .kernel_match import MatchDiag, match_hypotheses_kernel

_GROUP = 128        # the TPU matcher's lane chunk, kept as the group size
_KEEP = 64          # members of a kept group that stay as they are
_TRUST_THETA = float(np.float32(0.025))   # rad around a group's best
_TRUST_Y = float(np.float32(0.3))         # m around a group's best


def _smallest(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest scores in ``lax.top_k(-scores, k)``'s
    order: a stable ascending sort (ties by lower index; NaN sorts
    last)."""
    return torch.sort(scores, stable=True).indices[:k]


def _argmin_first(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmin`` over the last axis: the first NaN where a row has
    one, else the first smallest value."""
    nan = torch.isnan(x)
    first_nan = nan.to(torch.uint8).argmax(-1)
    first_min = torch.argmin(torch.where(nan, float("inf"), x), -1)
    return torch.where(nan.any(-1), first_nan, first_min)


def _pin_first(scores: torch.Tensor) -> torch.Tensor:
    """``scores`` with slot 0 set to -inf, so that it always survives (a
    fill, not an item assignment, which copies a host scalar and so
    cannot be captured in a CUDA graph)."""
    pinned = scores.clone()
    pinned[0].fill_(-float("inf"))
    return pinned


def _coarse_quad(quads, level: int):
    return quads[level] if quads is not None and len(quads) > level else None


def _subsampled(scan: Scan, beam_stride: int) -> Scan:
    return Scan(points=scan.points[::beam_stride], origo=scan.origo,
                mask=scan.mask[::beam_stride])


def prune_hypotheses_coarse(
    log_odds_pyramid: Sequence[torch.Tensor],
    hyp: torch.Tensor,          # f32[B, 3] world poses; slot 0 = incumbent
    scan: Scan,
    cfg: SlamConfig,
    top_k: int,
    beam_stride: int = 4,
    quads=None,
    group: int = _GROUP,
) -> torch.Tensor:
    """Keep the ``top_k`` hypotheses by coarsest-level map residual
    (beam-subsampled scan), always retaining slot 0 (the incumbent, which
    the acceptance bar downstream compares against). A ``group``-aligned
    batch keeps whole groups, scored by their best member (see
    ``_select_top``)."""
    coarse = cfg.map.levels - 1
    res_c = residual_for_poses(log_odds_pyramid[coarse], hyp,
                               _subsampled(scan, beam_stride), cfg,
                               quad=_coarse_quad(quads, coarse),
                               level=coarse)
    return _select_top(hyp, res_c, top_k, group)


def _select_top(hyp: torch.Tensor, scores: torch.Tensor, top_k: int,
                group: int = _GROUP) -> torch.Tensor:
    """Top-k selection keeping the batch's group structure: when shapes
    align, whole groups are kept (scored by their best member, a NaN
    member making the group's score NaN), slot 0's group always; else
    the ``top_k`` best hypotheses, slot 0 always. Survivors keep their
    batch order."""
    b = hyp.shape[0]
    if b % group == 0 and top_k % group == 0 and top_k >= group:
        g_scores = _pin_first(torch.amin(scores.reshape(-1, group), dim=1))
        g_idx = torch.sort(_smallest(g_scores, top_k // group)).values
        return hyp.reshape(-1, group, 3)[g_idx].reshape(-1, 3)
    idx = _smallest(_pin_first(scores), top_k)
    return hyp[torch.sort(idx).values]


def cascade_refine(
    log_odds_pyramid: Sequence[torch.Tensor],
    hyp: torch.Tensor,          # f32[B, 3]; slot 0 = incumbent
    scan: Scan,
    cfg: SlamConfig,
    quads=None,
    mid_top_k: int = 256,
    beam_stride: int = 4,
):
    """Cascaded wide-spread refinement through ``match_hypotheses_kernel``:
    refine all hypotheses on the coarsest level only, re-select the best
    ``mid_top_k`` by the next finer level's residual (incumbent forced),
    then run the remaining fine levels on that set: the moments kernel's
    level form launches once a level ((iterations + 1) GN steps inside),
    1 + (1 + 1) on ``BENCH_CONFIG``'s three levels.

    A group-aligned batch keeps whole groups of 128, then replaces each
    kept group's members that score worse than its 64th best, or lie
    outside a trust region around its best member (|dtheta| > 0.025 rad
    or |dy| > 0.3 m), by copies of that best member (recovery.py:153-191
    of the JAX package). The incumbent (slot 0 of group 0) is never
    replaced. Per-hypothesis numerics are the full pyramid schedule; the
    cascade only drops challengers between levels. Returns (MatchResult
    over the final set, MatchDiag summed over both stages)."""
    levels = cfg.map.levels
    coarse = levels - 1
    if levels == 1:
        return match_hypotheses_kernel(log_odds_pyramid, hyp, scan, cfg,
                                       quads=quads)
    mid_top_k = min(mid_top_k, hyp.shape[0])
    res1, d1 = match_hypotheses_kernel(log_odds_pyramid, hyp, scan, cfg,
                                       quads=quads, max_level=coarse,
                                       min_level=coarse)
    lvl = coarse - 1
    r = residual_for_poses(log_odds_pyramid[lvl], res1.pose,
                           _subsampled(scan, beam_stride), cfg,
                           quad=_coarse_quad(quads, lvl), level=lvl)
    b = res1.pose.shape[0]
    if b % _GROUP == 0 and mid_top_k % _GROUP == 0 and mid_top_k >= _GROUP:
        gk = mid_top_k // _GROUP
        r_g0 = r.reshape(-1, _GROUP)
        g_scores = _pin_first(torch.amin(r_g0, dim=1))
        g_idx = torch.sort(_smallest(g_scores, gk)).values
        poses_g = res1.pose.reshape(-1, _GROUP, 3)[g_idx]     # [gk,128,3]
        s_g = r_g0[g_idx]
        kth = torch.sort(s_g, dim=1).values[:, _KEEP - 1]
        best = _argmin_first(s_g)
        best_pose = poses_g[torch.arange(gk, device=best.device), best]
        d_th = (poses_g[..., 2] - best_pose[:, None, 2]).abs()
        d_y = (poses_g[..., 1] - best_pose[:, None, 1]).abs()
        repl = (s_g > kth[:, None]) | (d_th > _TRUST_THETA) | (d_y > _TRUST_Y)
        repl[0, 0].fill_(False)   # the incumbent: the acceptance bar
        surv = torch.where(repl[..., None], best_pose[:, None, :],
                           poses_g).reshape(-1, 3)
    else:
        surv = _select_top(res1.pose, r, mid_top_k)
    res2, d2 = match_hypotheses_kernel(log_odds_pyramid, surv, scan, cfg,
                                       quads=quads, max_level=lvl,
                                       min_level=0)
    return res2, MatchDiag(*(a + b for a, b in zip(d1, d2)))


def cascade_refine_jit(
    log_odds_pyramid: Sequence[torch.Tensor],
    hyp: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    quads=None,
    mid_top_k: int = 256,
    beam_stride: int = 4,
):
    """``cascade_refine`` compiled (the JAX package's
    ``cascade_refine_jit``, hector_slam_tpu/parallel/recovery.py:203-206):
    on the card ONE CUDA graph of both stages — the coarse
    ``match_hypotheses_kernel`` (one level launch of the moments kernel on
    ``BENCH_CONFIG``), the group re-selection with its trust region, and
    the fine stages (two level launches) — captured once per (``cfg``,
    whether ``quads`` are given, ``mid_top_k``, ``beam_stride``, shapes,
    the map's memory) and replayed with no host round trip. Its branches
    are decided on shapes alone, so the body reads nothing on the host.
    Returns (MatchResult, MatchDiag) as new tensors. On CPU tensors it
    runs eagerly.

    JAX's static ``k_budget``, ``interpret`` and ``wr`` have no
    counterpart: they size and run the TPU kernel's windows, and the
    card's kernel has none (``kernel_match.py``)."""
    if not graphs.on_card(hyp):
        return cascade_refine(log_odds_pyramid, hyp, scan, cfg, quads,
                              mid_top_k, beam_stride)
    levels = len(log_odds_pyramid)
    return graphs.call(
        "cascade_refine_jit",
        (cfg, quads is not None, mid_top_k, beam_stride),
        [*log_odds_pyramid, *(quads or ())], [hyp, *scan],
        lambda held, statics: cascade_refine(
            held[:levels], statics[0], Scan(*statics[1:4]), cfg,
            held[levels:] or None, mid_top_k, beam_stride))


def auto_prune_top_k(n_hypotheses: int) -> int:
    """Default survivor count: a quarter of the batch, floored at one
    128-hypothesis group; 0 (no pruning) below 512 hypotheses, where the
    full batch is already cheap."""
    if n_hypotheses < 512:
        return 0
    return max(128, int(np.ceil(n_hypotheses / 4 / 128)) * 128)
