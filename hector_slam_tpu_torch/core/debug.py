"""Matcher observability: per-GN-iteration Hessian diagnostics.

Counterpart of ``hector_slam_tpu/core/debug.py``: the reference's
hector_debug_info channel (src/HectorDebugInfoProvider.h:58-80 and
msg/HectorIterData.msg: hessian[9], determinant, conditionNum,
determinant2d, conditionNum2d) as stacked tensors. Condition numbers
follow the reference: the largest over the smallest eigenvalue, each
in closed form (the 3x3's from the trigonometric roots of its
characteristic cubic, in f64; the 2x2 translation block's from its
quadratic). JAX takes the 3x3's from ``eigvalsh``; torch's solvers read
their status on the host, which a CUDA graph cannot hold.

``match_pyramid_debug_jit`` is the JAX package's jitted debug match
(hector_slam_tpu/core/debug.py:98): on the card a CUDA graph
(core/graphs.py), the map held and the start pose and scan copied.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from ..config import SlamConfig
from ..ops.solve3 import det3
from ..types import Scan
from . import graphs
from .matcher import match_pyramid


class IterDiagnostics(NamedTuple):
    """One entry per GN iteration (leading axis = iteration, coarse -> fine,
    the debug topic's append order)."""

    hessian: torch.Tensor           # f32[I, 3, 3]
    determinant: torch.Tensor       # f32[I]
    condition_num: torch.Tensor     # f32[I] (3x3, eig_max / eig_min)
    determinant_2d: torch.Tensor    # f32[I] translation block
    condition_num_2d: torch.Tensor  # f32[I]


def _eig2_sym(a, b, c):
    """Eigenvalues (lo, hi) of [[a, b], [b, c]]."""
    tr = a + c
    diff = a - c
    root = torch.sqrt(diff * diff + 4.0 * b * b)
    return (tr - root) * 0.5, (tr + root) * 0.5


def _eig3_sym_extremes(hess: torch.Tensor):
    """(smallest, largest) eigenvalue of each symmetric [..., 3, 3], in
    f32 from f64 arithmetic: the trigonometric roots of the
    characteristic cubic (q + 2p cos(phi + 2 pi k / 3)), all equal to
    the mean of the diagonal where the matrix is a multiple of I."""
    a = hess.to(torch.float64)
    q = (a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]) / 3.0
    off = a[..., 0, 1] ** 2 + a[..., 0, 2] ** 2 + a[..., 1, 2] ** 2
    p = torch.sqrt(((a[..., 0, 0] - q) ** 2 + (a[..., 1, 1] - q) ** 2
                    + (a[..., 2, 2] - q) ** 2 + 2.0 * off) / 6.0)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    safe = torch.where(p > 0, p, 1.0)
    b = (a - q[..., None, None] * eye) / safe[..., None, None]
    r = torch.clamp(det3(b) / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    hi = q + 2.0 * p * torch.cos(phi)
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return lo.to(hess.dtype), hi.to(hess.dtype)


def _diagnostics(hess: torch.Tensor) -> IterDiagnostics:
    """The channel's numbers for Hessians f32[I, 3, 3]."""
    lo3, hi3 = _eig3_sym_extremes(hess)
    lo, hi = _eig2_sym(hess[:, 0, 0], hess[:, 0, 1], hess[:, 1, 1])
    det2 = hess[:, 0, 0] * hess[:, 1, 1] - hess[:, 0, 1] * hess[:, 1, 0]
    return IterDiagnostics(hessian=hess, determinant=det3(hess),
                           condition_num=hi3 / lo3,
                           determinant_2d=det2, condition_num_2d=hi / lo)


def match_pyramid_debug(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_estimate_world: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    quads: Sequence[torch.Tensor] | None = None,
):
    """Full coarse -> fine match returning (pose, final H,
    IterDiagnostics over every GN iteration of every level). It is
    ``match_pyramid`` itself (``quads`` as there) with every GN step's H
    traced, which takes the matcher's torch loop: the pose is bit-equal to
    ``match_pyramid``'s on CPU tensors, and on the card to a traced
    ``match_pyramid``'s (the untraced one runs the robot kernel,
    ops/robot_match.py, which rounds its sums in another order)."""
    hessians = []
    result = match_pyramid(log_odds_pyramid, begin_estimate_world, scan, cfg,
                           quads=quads, trace=hessians)
    return result.pose, hessians[-1], _diagnostics(torch.stack(hessians))


def match_pyramid_debug_jit(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_estimate_world: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    quads: Sequence[torch.Tensor] | None = None,
):
    """``match_pyramid_debug`` compiled (static ``cfg``): on the card a
    CUDA graph captured once per (``cfg``, whether ``quads`` is given,
    shapes, the map's and the quads' memory) and replayed with no host
    round trip; the results are new tensors, bit-equal to the eager
    function's. On CPU tensors it runs eagerly."""
    if not graphs.on_card(begin_estimate_world):
        return match_pyramid_debug(log_odds_pyramid, begin_estimate_world,
                                   scan, cfg, quads)
    levels = len(log_odds_pyramid)
    held = list(log_odds_pyramid) + list(quads or ())
    return graphs.call(
        "match_pyramid_debug_jit", (cfg, quads is not None), held,
        [begin_estimate_world, *scan],
        lambda maps, statics: match_pyramid_debug(
            maps[:levels], statics[0], Scan(*statics[1:4]), cfg,
            maps[levels:] or None))
