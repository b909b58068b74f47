"""Closed-form 3x3 linear solve for the Gauss-Newton normal equations,
batched over any leading axes.

Replaces Eigen's cofactor-based ``Matrix3f::inverse()`` used at
ScanMatcher.h:205 with the same adjugate formulation in float32, in the
same association as ``hector_slam_tpu/ops/solve3.py`` (verified there
bitwise against the compiled reference).
"""

from __future__ import annotations

import torch


def adjugate3(m: torch.Tensor) -> torch.Tensor:
    """Transposed cofactor matrix of a [..., 3, 3] tensor."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    row0 = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1)
    row1 = torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1)
    row2 = torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] as Eigen's fixed-size inverse computes it
    (InverseImpl.h compute_inverse<.,.,3>): column-0 cofactors, products
    cof*m, RIGHT-associated sum p0 + (p1 + p2)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = e * i - f * h          # cofactor<0,0>
    c10 = h * c - i * b          # cofactor<1,0>
    c20 = b * f - c * e          # cofactor<2,0>
    return c00 * a + (c10 * d + c20 * g)


def solve3(hess: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x = H^-1 @ rhs for [..., 3, 3] and [..., 3].

    No internal guard: a singular H yields inf/nan exactly as Eigen's
    ``inverse()`` would; the caller applies the reference's
    H(0,0)!=0 && H(1,1)!=0 guard (ScanMatcher.h:201). Each inverse entry
    is cofactor * (1/det), and the matvec is RIGHT-associated
    i0*b0 + (i1*b1 + i2*b2), as Eigen rounds them."""
    adj = adjugate3(hess)
    inv = adj * (1.0 / det3(hess))[..., None, None]
    return inv[..., :, 0] * rhs[..., None, 0] + (
        inv[..., :, 1] * rhs[..., None, 1]
        + inv[..., :, 2] * rhs[..., None, 2])
