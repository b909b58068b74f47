"""Matcher observability: per-GN-iteration Hessian diagnostics.

Counterpart of ``hector_slam_tpu/core/debug.py``: the reference's
hector_debug_info channel (src/HectorDebugInfoProvider.h:58-80 and
msg/HectorIterData.msg: hessian[9], determinant, conditionNum,
determinant2d, conditionNum2d) as stacked tensors. Condition numbers
follow the reference: the largest over the smallest eigenvalue (the 3x3
by a symmetric eigendecomposition, the 2x2 translation block in closed
form).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..config import SlamConfig
from ..ops.solve3 import det3
from ..types import Scan
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


def _diagnostics(hess: torch.Tensor) -> IterDiagnostics:
    """The channel's numbers for Hessians f32[I, 3, 3]."""
    eigs = torch.linalg.eigvalsh(hess)    # ascending
    lo, hi = _eig2_sym(hess[:, 0, 0], hess[:, 0, 1], hess[:, 1, 1])
    det2 = hess[:, 0, 0] * hess[:, 1, 1] - hess[:, 0, 1] * hess[:, 1, 0]
    return IterDiagnostics(hessian=hess, determinant=det3(hess),
                           condition_num=eigs[:, 2] / eigs[:, 0],
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
    traced, so the pose is bit-equal to ``match_pyramid``'s on the same
    inputs."""
    hessians = []
    result = match_pyramid(log_odds_pyramid, begin_estimate_world, scan, cfg,
                           quads=quads, trace=hessians)
    return result.pose, hessians[-1], _diagnostics(torch.stack(hessians))
