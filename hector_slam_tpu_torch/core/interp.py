"""Beam-parallel bilinear map interpolation with hector_slam's quirk
gradients, and the JtJ/JtR normal-equation accumulation.

Counterpart of ``hector_slam_tpu/core/interp.py`` (the reference's
OccGridMapUtil::interpMapValueWithDerivatives, OccGridMapUtil.h:287-347,
and getCompleteHessianDerivs, :64-104). ``quad_pack`` precomputes, once
per map epoch, a [H*W, 4] tensor holding (P00, P10, P01, P11) for every
cell, so a query fetches its 2x2 neighbourhood with one gather (one
16-byte load in the CUDA kernel, ops/interp_moments.py).

Discrete behaviours replicated exactly:
  - out-of-bounds rule ``coord < 0 or coord > size-2``
    (MapDimensionProperties.h:65-73) -> (0,0,0) contribution
  - floor by int cast (OccGridMapUtil.h:295)
  - GRADIENT QUIRK (OccGridMapUtil.h:332-346): the x-gradient blends the
    two row differences with the *x* fraction, the y-gradient the column
    differences with the *y* fraction.

Every function here takes a pose f32[3] or a batch of poses f32[B, 3]
(hypotheses sharing one scan, or robots with a scan and a map each); the
hypothesis batch is the plain version of the moments kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .cell_models import prob_grid, storage_to_prob


def quad_pack(prob: torch.Tensor) -> torch.Tensor:
    """Probability grid f32[..., H, W] -> f32[..., H*W, 4] neighbour quads
    (P00, P10, P01, P11 per cell). The rolled wrap-around entries in the
    last row/column are never read: interp clips cell indices to
    (h-2, w-2)."""
    p10 = torch.roll(prob, -1, dims=-1)
    p01 = torch.roll(prob, -1, dims=-2)
    p11 = torch.roll(p01, -1, dims=-1)
    lead = prob.shape[:-2]
    return torch.stack([t.reshape(lead + (-1,)) for t in (prob, p10, p01,
                                                            p11)], dim=-1)


def quad_pack_storage(storage: torch.Tensor, cell_model: str) -> torch.Tensor:
    """Storage grid -> probability quads (prob_grid then quad_pack)."""
    return quad_pack(prob_grid(storage, cell_model))


def _cells(coords: torch.Tensor, shape):
    """Bounds flag, clipped int-cast cell and fractions of map coords."""
    h, w = shape
    x = coords[..., 0]
    y = coords[..., 1]
    in_bounds = ((x >= 0.0) & (x <= float(w - 2))
                 & (y >= 0.0) & (y <= float(h - 2)))
    xi = torch.clamp(x.to(torch.int32), 0, w - 2)
    yi = torch.clamp(y.to(torch.int32), 0, h - 2)
    fx = x - xi.to(torch.float32)
    fy = y - yi.to(torch.float32)
    return in_bounds, xi, yi, fx, fy


def _neighbor_derivs(p00, p10, p01, p11, fx, fy, in_bounds):
    """Bilinear value + quirk gradients (OccGridMapUtil.h:332-346)."""
    dx1 = p00 - p10
    dx2 = p01 - p11
    dy1 = p00 - p01
    dy2 = p10 - p11
    xfi = 1.0 - fx
    yfi = 1.0 - fy
    value = (p00 * xfi + p10 * fx) * yfi + (p01 * xfi + p11 * fx) * fy
    grad_x = -((dx1 * xfi) + (dx2 * fx))   # quirk: x-weighted row blend
    grad_y = -((dy1 * yfi) + (dy2 * fy))   # quirk: y-weighted column blend
    zero = torch.zeros((), dtype=value.dtype, device=value.device)
    return (torch.where(in_bounds, value, zero),
            torch.where(in_bounds, grad_x, zero),
            torch.where(in_bounds, grad_y, zero))


def _interp_quad_bounds(quad, shape, coords):
    """Gathers each query's quad: from one grid ``quad`` f32[H*W, 4], or,
    for per-robot grids f32[R, H*W, 4], robot r's queries (``coords[r]``)
    from grid r through an int64 offset r*H*W."""
    in_bounds, xi, yi, fx, fy = _cells(coords, shape)
    w = shape[1]
    flat = yi.to(torch.int64) * w + xi.to(torch.int64)
    if quad.dim() == 3:
        r = quad.shape[0]
        base = torch.arange(r, dtype=torch.int64, device=flat.device) \
            * quad.shape[1]
        flat = flat + base.reshape((r,) + (1,) * (flat.dim() - 1))
    nbrs = quad.reshape(-1, 4)[flat.reshape(-1)].reshape(xi.shape + (4,))
    out = _neighbor_derivs(nbrs[..., 0], nbrs[..., 1], nbrs[..., 2],
                           nbrs[..., 3], fx, fy, in_bounds)
    return out, in_bounds


def interp_quad(
    quad: torch.Tensor,           # f32[H*W, 4] from quad_pack
    shape: Tuple[int, int],       # (H, W) of the underlying grid
    coords: torch.Tensor,         # f32[..., 2] map coords
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """interp_with_derivatives over a quad-packed prob grid: one gather
    per query instead of four."""
    return _interp_quad_bounds(quad, shape, coords)[0]


def interp_with_derivatives(
    log_odds: torch.Tensor,   # f32[H, W] one pyramid level
    coords: torch.Tensor,     # f32[..., 2] map coords
    cell_model: str = "log_odds",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (M, dM/dx, dM/dy); zeros when out of bounds. The 4-gather
    executable spec that ``interp_quad`` is held bit-equal to."""
    in_bounds, xi, yi, fx, fy = _cells(coords, log_odds.shape)
    xi = xi.to(torch.int64)
    yi = yi.to(torch.int64)
    p00 = storage_to_prob(log_odds[yi, xi], cell_model)
    p10 = storage_to_prob(log_odds[yi, xi + 1], cell_model)
    p01 = storage_to_prob(log_odds[yi + 1, xi], cell_model)
    p11 = storage_to_prob(log_odds[yi + 1, xi + 1], cell_model)
    return _neighbor_derivs(p00, p10, p01, p11, fx, fy, in_bounds)


class NormalEqs(NamedTuple):
    hess: torch.Tensor   # f32[..., 3, 3] J^T J
    dtr: torch.Tensor    # f32[..., 3]    J^T (1 - M)
    used: torch.Tensor   # f32[...] in-bounds valid queries per pose


def beam_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the last (beam) axis in a fixed pairwise order: add the
    upper half of the columns onto the lower half until one is left; an
    odd count first folds its last column into the first. Every step is
    elementwise, so a row's sum does not depend on the batch it sits in or
    on the device's reduction kernel: a fleet's robot r sums exactly as a
    lone ``slam_step`` does. (``torch.sum`` picks its order from the
    shape.)"""
    while terms.shape[-1] > 1:
        n = terms.shape[-1]
        half = n // 2
        head = terms[..., :half] + terms[..., half:2 * half]
        if n % 2:
            head[..., :1] += terms[..., 2 * half:]
        terms = head
    return terms[..., 0]


def normal_eqs_quad(
    quad: torch.Tensor,        # f32[H*W, 4] or per-robot f32[R, H*W, 4]
    shape: Tuple[int, int],
    pose_map: torch.Tensor,    # f32[3] or f32[B, 3] map-frame poses
    points: torch.Tensor,      # f32[N, 2] or per-pose f32[B, N, 2]
    mask: torch.Tensor,        # bool[N] or bool[B, N]
) -> NormalEqs:
    """getCompleteHessianDerivs over a quad-packed grid for one pose or a
    batch of poses, plus the count of queries that contributed. Padded
    and out-of-bounds beams contribute exactly zero (their gradients are
    zero), as the reference skips them via the (0,0,0) interp return.

    A batch either shares one scan (B hypotheses, points [N, 2]) or has
    one scan per pose (R robots, points [R, N, 2]); per-robot quads
    [R, H*W, 4] give each robot its own map.

    The nine moments are summed as elementwise products reduced over the
    beam axis by ``beam_sum`` (no matmul, so no TF32 path on the card);
    only the f32 summation order differs from the JAX ``jnp.dot``."""
    sin_rot = torch.sin(pose_map[..., 2:3])
    cos_rot = torch.cos(pose_map[..., 2:3])
    px = points[..., 0]
    py = points[..., 1]
    # Eigen applies Affine2f as m00*px + (m01*py + t)
    # (hector_slam_tpu/core/interp.py:184-189); torch keeps the association
    tx = cos_rot * px + (-sin_rot * py + pose_map[..., 0:1])
    ty = sin_rot * px + (cos_rot * py + pose_map[..., 1:2])
    (m, gx, gy), in_bounds = _interp_quad_bounds(
        quad, shape, torch.stack([tx, ty], dim=-1))
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    gx = torch.where(mask, gx, zero)
    gy = torch.where(mask, gy, zero)
    m = torch.where(mask, m, zero)
    fun = 1.0 - m
    rot = (-sin_rot * px - cos_rot * py) * gx + \
        (cos_rot * px - sin_rot * py) * gy
    rot = torch.where(mask, rot, zero)
    used = (in_bounds & mask).sum(dim=-1).to(torch.float32)
    return NormalEqs(*moment_sums(gx, gy, rot, fun), used)


def moment_sums(gx: torch.Tensor, gy: torch.Tensor, rot: torch.Tensor,
                fun: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(J^T J f32[..., 3, 3], J^T fun f32[..., 3]) of the per-beam
    Jacobian rows (gx, gy, rot) and residuals ``fun``, each [..., N],
    summed over the beam axis by ``beam_sum``."""
    # (gx, gy, rot) times (gx, gy, rot, fun) in one [3, 4, ..., N] product:
    # J^T J and J^T (1-M) side by side (the lower triangle repeats the
    # upper one bit for bit)
    f = torch.stack([gx, gy, rot, fun])
    s = beam_sum(f[:3, None] * f[None])                    # [3, 4, ...]
    return s[:, :3].movedim((0, 1), (-2, -1)), s[:, 3].movedim(0, -1)


def assemble_hessian(xx, xy, xt, yy, yt, tt) -> torch.Tensor:
    """Symmetric [..., 3, 3] from the six upper-triangle moments."""
    return torch.stack([torch.stack([xx, xy, xt], -1),
                        torch.stack([xy, yy, yt], -1),
                        torch.stack([xt, yt, tt], -1)], -2)


def hessian_derivs_quad(
    quad: torch.Tensor,
    shape: Tuple[int, int],
    pose_map: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H f32[..., 3, 3], dTr f32[..., 3]) — the sequential matcher's
    hot path (one gather per beam)."""
    eqs = normal_eqs_quad(quad, shape, pose_map, points, mask)
    return eqs.hess, eqs.dtr


def hessian_derivs(
    log_odds: torch.Tensor,    # f32[H, W] one pyramid level's storage
    pose_map: torch.Tensor,    # f32[3] pose in this level's map coords
    points: torch.Tensor,      # f32[N, 2] beam endpoints (map scale)
    mask: torch.Tensor,        # bool[N]
    cell_model: str = "log_odds",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """getCompleteHessianDerivs (OccGridMapUtil.h:64-104) from a level's
    storage: (H f32[3, 3], dTr f32[3]). The storage is quad-packed and
    summed by ``normal_eqs_quad``, so the sums run in the matcher's order
    and the values are ``interp_with_derivatives``' (the quad fetch is
    bit-equal to the four gathers)."""
    return hessian_derivs_quad(quad_pack_storage(log_odds, cell_model),
                               tuple(log_odds.shape[-2:]), pose_map, points,
                               mask)
