"""The theta-bucketed patch matcher: batched pyramid matching whose fast
path reads each query's four bilinear neighbours from a patch shared by a
bucket of hypotheses and a group of adjacent beams.

Counterpart of ``hector_slam_tpu/parallel/onehot_match.py``, name for
name. Per pyramid level and GN step:
  1. sort the hypotheses by theta (a stable sort: stratified samplers put
     many hypotheses on one theta) and split them into G buckets of S;
  2. per (bucket, group of GROUP beams): the patch base is the smallest
     cell of the bucket's hypotheses and the group's valid beams,
     clipped so that a [PATCH_H, PATCH_W] patch fits the grid; a query
     whose 2x2 neighbourhood leaves its patch is left out of the fast
     path (``fits_q``);
  3. the fast path: each bucket's patches are staged and each fitting
     query's four neighbours read from them, then the bilinear value,
     the quirk gradients and the per-hypothesis J^T J and J^T (1-M);
  4. the left-out queries are repaired one by one
     (``ops/interp_moments.bad_query_corrections``) while there are at
     most ``k_budget``; past the budget the step takes the full quad
     path for every query.

JAX selects the neighbours with one-hot contractions on the TPU's matrix
unit (``precision=HIGH`` or an exact three-part bf16 split), where each
output has one nonzero product, so the selected value is the cell's f32
value. The port reads the same values with index gathers from the same
staged patch: bit-equal, exact under any float32 matmul precision, and
without the [NG, 8 S, PATCH_W] one-hot tensor. ``onehot_bf16`` chose
the one-hot's dtype and changes nothing here, as it changes nothing in
JAX's results.

JAX's two ``lax.cond``s (repair when 0 < n_bad <= k_budget, the full
path past the budget) become ``torch.where`` selects of branches that
always run, so a step reads nothing on the host and the compiled entry
point is one CUDA graph. The full path is ``interp_moments``, the
moments kernel (the batched ``hessian_derivs_quad``; its plain version
on the CPU): one launch a GN step, a few microseconds on the card. A
branch not taken is selected away, never added as zeros.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import SlamConfig
from ..core import graphs
from ..core.cell_models import prob_grid
from ..core.grid import world_to_map_pose
from ..core.interp import _neighbor_derivs, moment_sums, quad_pack
from ..core.matcher import finish_level, guarded_step, level_points
from ..ops.interp_moments import bad_query_corrections, interp_moments
from ..types import MatchResult, Scan, host_array
from .kernel_match import MatchDiag

PATCH_H = 64   # max patch rows (clamped to the level's grid height)
PATCH_W = 256  # max patch cols (grazing wall hits slide far along a wall)
GROUP = 8      # adjacent beams sharing one patch


def _transform(poses_map: torch.Tensor, points: torch.Tensor):
    """Map-frame query coords tx, ty [B, N] for poses [B, 3]."""
    s = torch.sin(poses_map[:, 2])[:, None]
    c = torch.cos(poses_map[:, 2])[:, None]
    px = points[None, :, 0]
    py = points[None, :, 1]
    # Eigen affine order: m00*px + (m01*py + t) (see core/interp.py)
    tx = c * px + (-s * py + poses_map[:, 0:1])
    ty = s * px + (c * py + poses_map[:, 1:2])
    return tx, ty


def _patch_dims(grid_shape, patch_h=PATCH_H, patch_w=PATCH_W):
    h, w = grid_shape
    return min(patch_h, h), min(patch_w, w)


def _cells_and_extents(grid_shape, poses_map, points, mask, num_buckets,
                       patch_h=PATCH_H, patch_w=PATCH_W):
    """Sorted poses, per-query cells and fractions, per-(bucket, beam
    group) patch bases, and the per-query fit mask. Masked (padded) beams
    neither move a patch base nor count as misfits."""
    h, w = grid_shape
    b_total = poses_map.shape[0]
    s_per = b_total // num_buckets
    n = points.shape[0]
    ng = n // GROUP

    order = torch.argsort(poses_map[:, 2], stable=True)
    pm = poses_map[order]
    tx, ty = _transform(pm, points)                  # [B, N]

    in_bounds = ((tx >= 0.0) & (tx <= float(w - 2))
                 & (ty >= 0.0) & (ty <= float(h - 2)))
    xi = torch.clamp(tx.to(torch.int32), 0, w - 2)
    yi = torch.clamp(ty.to(torch.int32), 0, h - 2)
    fx = tx - xi.to(torch.float32)
    fy = ty - yi.to(torch.float32)

    # bucket/group views [G, S, NG, GROUP]; masked beams take the sentinel
    # so that they do not drag the patch base toward the scan origin
    xi_m = torch.where(mask[None, :], xi, w - 2)
    yi_m = torch.where(mask[None, :], yi, h - 2)
    ph, pw = _patch_dims(grid_shape, patch_h, patch_w)
    xi_b = xi_m.reshape(num_buckets, s_per, ng, GROUP)
    yi_b = yi_m.reshape(num_buckets, s_per, ng, GROUP)
    x0 = torch.clamp(xi_b.amin(dim=(1, 3)), 0, w - pw)   # [G, NG]
    y0 = torch.clamp(yi_b.amin(dim=(1, 3)), 0, h - ph)
    cx = xi_b - x0[:, None, :, None]
    ry = yi_b - y0[:, None, :, None]
    # per query: does the 2x2 bilinear neighbourhood fit its patch?
    fits_q = ((cx <= pw - 2) & (ry <= ph - 2)).reshape(b_total, n)
    return order, pm, tx, ty, in_bounds, fx, fy, cx, ry, x0, y0, fits_q


def _normal_eqs_fast(grid, shape, pm, in_bounds, fx, fy, cx, ry,
                     x0, y0, fits_q, points, mask, num_buckets,
                     patch_h=PATCH_H, patch_w=PATCH_W, onehot_bf16=False):
    """(H [B, 3, 3], dTr [B, 3]) in sorted-pose order from the bucketed
    patches, one bucket at a time so that one bucket's temporaries live
    at once. Queries that do not fit their patch (``~fits_q``) contribute
    exactly zero; the caller repairs them. ``onehot_bf16``: see the
    module docstring."""
    del onehot_bf16
    b_total = pm.shape[0]
    s_per = b_total // num_buckets
    n = points.shape[0]
    ng = n // GROUP

    sin_b = torch.sin(pm[:, 2]).reshape(num_buckets, s_per)
    cos_b = torch.cos(pm[:, 2]).reshape(num_buckets, s_per)
    fx_b = fx.reshape(num_buckets, s_per, n)
    fy_b = fy.reshape(num_buckets, s_per, n)
    valid_b = (in_bounds & fits_q & mask[None, :]).reshape(num_buckets,
                                                           s_per, n)
    px = points[None, :, 0]
    py = points[None, :, 1]

    ph, pw = _patch_dims(shape, patch_h, patch_w)
    dev = grid.device
    r_iota = torch.arange(ph, dtype=torch.int64, device=dev)
    c_iota = torch.arange(pw, dtype=torch.int64, device=dev)
    # the four neighbours' offsets in a patch's flat [ph * pw] index:
    # (0, 1, pw, pw + 1), the order of quad_pack's (P00, P10, P01, P11)
    two = torch.arange(2, dtype=torch.int64, device=dev)
    corner = (two[:, None] * pw + two[None, :]).reshape(4)

    hs, ds = [], []
    for g in range(num_buckets):
        # [NG, ph, pw] patches at (y0, x0); the bases already lie in
        # [0, h - ph] x [0, w - pw], where JAX's CLIP gather keeps them
        rows = y0[g].to(torch.int64)[:, None] + r_iota    # [NG, ph]
        cols = x0[g].to(torch.int64)[:, None] + c_iota    # [NG, pw]
        patches = grid[rows[:, :, None], cols[:, None, :]]
        # queries of this bucket, hypothesis-major: [S, NG, GROUP] ->
        # [NG, S * GROUP]; a fitting query's corner (ry, cx) lies in
        # [0, ph-2] x [0, pw-2], the clamp only keeps the others' reads
        # inside the patch (their results are selected away below)
        cx_g = torch.clamp(cx[g], 0, pw - 2).permute(1, 0, 2)
        ry_g = torch.clamp(ry[g], 0, ph - 2).permute(1, 0, 2)
        base = (ry_g * pw + cx_g).reshape(ng, s_per * GROUP).to(torch.int64)
        idx = (base[:, :, None] + corner).reshape(ng, -1)
        nbrs = patches.reshape(ng, ph * pw).gather(1, idx)
        # [NG, S, GROUP, 4] -> [S, N, 4], the bucket's hypotheses by beam
        nbrs = nbrs.reshape(ng, s_per, GROUP, 4).permute(1, 0, 2, 3) \
            .reshape(s_per, n, 4)
        valid = valid_b[g]
        m, gx, gy = _neighbor_derivs(nbrs[..., 0], nbrs[..., 1],
                                     nbrs[..., 2], nbrs[..., 3],
                                     fx_b[g], fy_b[g], valid)
        s_g = sin_b[g][:, None]
        c_g = cos_b[g][:, None]
        rot = (-s_g * px - c_g * py) * gx + (c_g * px - s_g * py) * gy
        rot = torch.where(valid, rot, torch.zeros((), dtype=rot.dtype,
                                                  device=dev))
        hess, dtr = moment_sums(gx, gy, rot, 1.0 - m)
        hs.append(hess)
        ds.append(dtr)
    return torch.cat(hs), torch.cat(ds)


def gn_step_batch(grid, quad, shape, estimates_map, points, mask,
                  num_buckets, patch_h=PATCH_H, patch_w=PATCH_W,
                  onehot_bf16=False, k_budget=4096):
    """One batched GN step: the bucketed fast path, the granular repair
    of its left-out queries, and past ``k_budget`` of them the full quad
    path, then the guarded, clamped solve per hypothesis
    (ScanMatcher.h:194-226). Every branch runs and ``torch.where``
    selects, so nothing is read on the host.

    Returns (new_estimates, hess, (n_bad i32[], overflowed bool[]))."""
    (order, pm, tx, ty, in_bounds, fx, fy, cx, ry, x0, y0, fits_q) = \
        _cells_and_extents(shape, estimates_map, points, mask, num_buckets,
                           patch_h, patch_w)

    hess_s, dtr_s = _normal_eqs_fast(
        grid, shape, pm, in_bounds, fx, fy, cx, ry, x0, y0, fits_q,
        points, mask, num_buckets, patch_h, patch_w, onehot_bf16)

    bad = in_bounds & mask[None, :] & ~fits_q
    n_bad = bad.sum(dtype=torch.int32)
    overflowed = n_bad > k_budget

    h_c, d_c = bad_query_corrections(
        quad, shape, tx, ty, torch.sin(pm[:, 2]), torch.cos(pm[:, 2]),
        points, bad, k_budget)
    # past the budget the incomplete repair is discarded for the full path
    repair = (n_bad > 0) & ~overflowed
    hess_s = torch.where(repair, hess_s + h_c, hess_s)
    dtr_s = torch.where(repair, dtr_s + d_c, dtr_s)
    inv = torch.argsort(order)
    hess = hess_s[inv]
    dtr = dtr_s[inv]

    slow = interp_moments(quad, shape, estimates_map.contiguous(),
                          points, mask)
    hess = torch.where(overflowed, slow.hess, hess)
    dtr = torch.where(overflowed, slow.dtr, dtr)
    return guarded_step(estimates_map, hess, dtr), hess, (n_bad, overflowed)


def match_hypotheses_mxu(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_poses: torch.Tensor,   # f32[B, 3] world poses
    scan: Scan,
    cfg: SlamConfig,
    num_buckets: int = 0,        # 0 -> min(16, max(2, B // 1024))
    patch_h: int = PATCH_H,
    patch_w: int = PATCH_W,
    onehot_bf16: bool = False,
    k_budget: int = 4096,
    with_diag: bool = False,
):
    """Batched coarse-to-fine pyramid matcher (the contract of
    ``match_hypotheses``) with the patch fast path, the granular repair
    and, past ``k_budget`` left-out queries in a GN step, the full path
    for that step. ``num_buckets`` is lowered until it divides B;
    ``auto_num_buckets`` picks it from the hypotheses' theta spread.
    With ``with_diag`` returns (MatchResult, MatchDiag): repaired
    queries (overflowed steps left out), overflowed steps, and the
    total and slow query counts (every query of an overflowed step is
    slow)."""
    mcfg = cfg.map
    model = cfg.update.cell_model
    b_total = begin_poses.shape[0]
    if num_buckets <= 0:
        num_buckets = min(16, max(2, b_total // 1024))
    while b_total % num_buckets:
        num_buckets -= 1

    # the 8-beam groups need a GROUP multiple of beams: pad with masked
    # beams at the origin
    points, mask = scan.points, scan.mask
    n = points.shape[0]
    if n % GROUP:
        pad = GROUP - n % GROUP
        points = torch.cat([points, points.new_zeros((pad, 2))])
        mask = torch.cat([mask, mask.new_zeros(pad)])
    mask = mask.contiguous()

    dev = begin_poses.device
    poses = begin_poses
    hess = torch.zeros((b_total, 3, 3), dtype=torch.float32, device=dev)
    n_bad_total = torch.zeros((), dtype=torch.int32, device=dev)
    overflow_steps = torch.zeros((), dtype=torch.int32, device=dev)
    slow_queries = torch.zeros((), dtype=torch.float32, device=dev)
    total_queries = 0.0   # a host float, as in JAX: no i32 overflow
    any_valid = mask.any()
    for level in range(mcfg.levels - 1, -1, -1):
        pts = level_points(points, level).contiguous()
        iters = (cfg.match.iterations_finest if level == 0
                 else cfg.match.iterations_coarse)
        shape = tuple(log_odds_pyramid[level].shape[-2:])
        grid = prob_grid(log_odds_pyramid[level], model)
        quad = quad_pack(grid)
        offset = mcfg.top_left_offset
        est = world_to_map_pose(poses, offset, mcfg.level_scale(level))
        for _ in range(iters + 1):
            est, hess, (n_bad, ovf) = gn_step_batch(
                grid, quad, shape, est, pts, mask, num_buckets, patch_h,
                patch_w, onehot_bf16, k_budget)
            n_bad_total = n_bad_total + torch.where(ovf, 0, n_bad)
            overflow_steps = overflow_steps + ovf.to(torch.int32)
            qcount = float(b_total * pts.shape[0])
            slow_queries = slow_queries + torch.where(
                ovf, qcount, n_bad.to(torch.float32))
            total_queries += qcount
        world = finish_level(est, offset, mcfg.level_resolution(level))
        poses = torch.where(any_valid, world, poses)
        hess = torch.where(any_valid, hess, torch.zeros_like(hess))
    result = MatchResult(pose=poses, hessian=hess)
    if with_diag:
        total = torch.zeros((), dtype=torch.float32, device=dev) \
            + float(np.float32(total_queries))
        return result, MatchDiag(n_bad_total, overflow_steps, total,
                                 slow_queries)
    return result


def auto_num_buckets(begin_poses, b_total: int | None = None) -> int:
    """The theta-bucket count for these hypotheses' actual spread, on the
    host (pass the result as ``num_buckets``): a bucket's theta range
    sweeps about range x beam radius cells across its hypotheses, and a
    [PATCH_H, PATCH_W] patch absorbs ~60 rows, so buckets split until
    spread_per_bucket * 300 cells (a UTM-30LX's range) fits."""
    theta = host_array(begin_poses)[:, 2]
    b = b_total or theta.shape[0]
    spread = float(theta.max() - theta.min()) if theta.size else 0.0
    for g in (2, 4, 8, 16, 32):
        per_bucket = spread / g
        if per_bucket * 300.0 <= (PATCH_H - 8) or g >= min(32, b // 128):
            break
    while b % g:
        g -= 1
    return max(1, g)


def match_hypotheses_mxu_jit(
    log_odds_pyramid: Sequence[torch.Tensor],
    begin_poses: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    num_buckets: int = 0,
    patch_h: int = PATCH_H,
    patch_w: int = PATCH_W,
    onehot_bf16: bool = False,
    k_budget: int = 4096,
    with_diag: bool = False,
):
    """``match_hypotheses_mxu`` compiled (JAX's ``match_hypotheses_mxu_jit``,
    static ``cfg``, ``num_buckets``, ``patch_h``, ``patch_w``,
    ``onehot_bf16``, ``k_budget``, ``with_diag``): on the card a CUDA
    graph captured once per static signature, shapes and map memory and
    replayed with no host round trip; the results are new tensors. On
    CPU tensors it runs eagerly."""
    statics = (num_buckets, patch_h, patch_w, onehot_bf16, k_budget,
               with_diag)
    if not graphs.on_card(begin_poses):
        return match_hypotheses_mxu(log_odds_pyramid, begin_poses, scan, cfg,
                                    *statics)
    return graphs.call(
        "match_hypotheses_mxu_jit", (cfg, *statics), list(log_odds_pyramid),
        [begin_poses, *scan],
        lambda levels, copied: match_hypotheses_mxu(
            levels, copied[0], Scan(*copied[1:4]), cfg, *statics))
