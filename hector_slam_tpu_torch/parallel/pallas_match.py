"""The JAX package's Pallas-route names, on the card's moments kernel.

Counterpart of ``hector_slam_tpu/parallel/pallas_match.py:
match_hypotheses_pallas`` and ``match_hypotheses_pallas_jit``, with their
signature. JAX's route tiles the hypotheses into theta sub-buckets of
``s_per``, stages [``wr``, ``wc``] VMEM windows for ``bpb`` beams a
kernel block, repairs up to ``k_budget`` window-overflow queries a GN
step and can run in Mosaic interpret mode (``interpret``). All of that
shapes TPU windows only: JAX's own paths give the same numerics
(pallas_match.py:23-24). The card's moments kernel reads the whole quad
grid and has no windows, so these arguments are accepted and change
nothing: both names return what ``match_hypotheses_kernel`` and
``match_hypotheses_kernel_jit`` return (parallel/kernel_match.py), whose
``MatchDiag`` reports every query on the kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import SlamConfig
from ..types import MatchResult, Scan
from .kernel_match import (MatchDiag, match_hypotheses_kernel,
                           match_hypotheses_kernel_jit)

# JAX's window defaults (hector_slam_tpu/ops/pallas_interp.py:77-79)
WR = 24    # window rows
WC = 256   # window columns
BPB = 8    # beams per kernel block


def match_hypotheses_pallas(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_poses: torch.Tensor,   # f32[B, 3] world poses
    scan: Scan,
    cfg: SlamConfig,
    s_per: int = 1024,
    wr: int = WR,
    wc: int = WC,
    bpb: int = BPB,
    k_budget: int = 4096,
    interpret: bool = False,
    quads: Sequence[torch.Tensor] | None = None,
    max_level: int | None = None,
    min_level: int = 0,
) -> Tuple[MatchResult, MatchDiag]:
    """``match_hypotheses_kernel`` under JAX's name and signature;
    ``s_per``, ``wr``, ``wc``, ``bpb``, ``k_budget`` and ``interpret``
    shape TPU windows only (see the module docstring)."""
    return match_hypotheses_kernel(log_odds_pyramid, begin_poses, scan, cfg,
                                   quads, max_level, min_level)


def match_hypotheses_pallas_jit(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_poses: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    s_per: int = 1024,
    wr: int = WR,
    wc: int = WC,
    bpb: int = BPB,
    k_budget: int = 4096,
    interpret: bool = False,
    quads: Sequence[torch.Tensor] | None = None,
    max_level: int | None = None,
    min_level: int = 0,
) -> Tuple[MatchResult, MatchDiag]:
    """``match_hypotheses_kernel_jit`` (one CUDA graph on the card, eager
    on CPU tensors) under JAX's name and signature; the window arguments
    change nothing."""
    return match_hypotheses_kernel_jit(log_odds_pyramid, begin_poses, scan,
                                       cfg, quads, max_level, min_level)
