"""The least time the card needs for a cell's work, counted from the
cell's inputs alone (shapes, scans, true poses, hypotheses), never from
the program's outputs, with the peaks of one H100 SXM.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TFLOP/s
of float32 outside the tensor cores, at the card's full 700 W (the run's
result line names the card's power limit beside them). The operation
counts per query are a frozen copy of ``chip_smoke.py``'s
``OPS_PER_USED_QUERY`` / ``OPS_PER_OTHER_QUERY`` and the byte count of
its ``kernel_bound_ms``, with the cell indexing written out here.

  moments  per Gauss-Newton step: every valid query's transform,
           bilinear value, gradient and moment terms (53 f32 operations
           in bounds, 8 out); bytes: the distinct map cells the in-bounds
           queries read (a 16-byte quad each), the poses, their sine and
           cosine and the outputs (60 bytes a hypothesis) and the points
           and mask (9 bytes a beam), each once. The first step of a
           level reads at the hypotheses' own poses, the later ones at
           the true pose, where the matcher converges.
  match    the moments plus each hypothesis's guarded 3x3 solve, clamp
           and pose update every step (``SOLVE_OPS``), and its pose read
           and written once a level (24 bytes).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..reference import slam_ref

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_USED_QUERY = 53
OPS_PER_OTHER_QUERY = 8
# a hypothesis's GN update: guard 2, six cofactors 18, determinant 5,
# adjugate times the gradient 15, three divisions 3, clamp 2, update 3
SOLVE_OPS = 48


def least_s(ops: float, bytes_: float) -> float:
    return max(ops / F32_OPS_PER_S, bytes_ / HBM_BYTES_PER_S)


def _queries(lv: slam_ref.Level, poses: torch.Tensor, points: torch.Tensor,
             mask: torch.Tensor, factor: float):
    """(used, valid, distinct cells) of one GN step's queries: points
    [N, 2] at world poses [B, 3] on level ``lv``."""
    est = torch.cat([slam_ref.world_to_map(poses[:, :2], lv), poses[:, 2:]],
                    -1)
    px = points[:, 0].to(est.dtype) * factor
    py = points[:, 1].to(est.dtype) * factor
    s, c = torch.sin(est[:, 2:3]), torch.cos(est[:, 2:3])
    x = c * px + (-s * py + est[:, 0:1])
    y = s * px + (c * py + est[:, 1:2])
    used = (mask & (x >= 0) & (x <= lv.size_x - 2) & (y >= 0)
            & (y <= lv.size_y - 2))
    cells = (torch.trunc(y).to(torch.int64) * lv.size_x
             + torch.trunc(x).to(torch.int64))[used]
    return (int(used.sum()), int(mask.sum()) * poses.shape[0],
            int(torch.unique(cells).numel()))


def match_work(p: slam_ref.Params, starts: torch.Tensor, true: torch.Tensor,
               points: torch.Tensor, mask: torch.Tensor) -> Tuple[float, ...]:
    """(moments ops, moments bytes, match ops, match bytes) of one batched
    match: hypotheses ``starts`` [B, 3] about the true pose [3] of a scan
    (points [N, 2], mask [N])."""
    b, n = starts.shape[0], points.shape[0]
    m_ops = m_bytes = x_ops = x_bytes = 0.0
    for i in range(len(p.levels) - 1, -1, -1):
        lv = p.levels[i]
        factor = 1.0 / 2.0 ** i
        first = _queries(lv, starts.double(), points, mask, factor)
        later = _queries(lv, true.double()[None], points, mask, factor)
        for step in range(lv.iterations + 1):
            used, valid, cells = first if step == 0 else (
                later[0] * b, later[1] * b, later[2])
            m_ops += OPS_PER_USED_QUERY * used + OPS_PER_OTHER_QUERY * (
                valid - used)
            m_bytes += cells * 16 + b * 60 + n * 9
            x_ops += SOLVE_OPS * b
        x_bytes += 24 * b
    return m_ops, m_bytes, m_ops + x_ops, m_bytes + x_bytes
