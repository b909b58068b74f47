"""Batched interpolation + normal-equation moments: the CUDA kernel
``csrc/interp_moments.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``hector_slam_tpu/ops/pallas_interp.py:
interp_moments_pallas`` together with its granular repair: for every
hypothesis the nine moments of J^T J and J^T (1-M) over all beams, the
totals vmapped ``hessian_derivs_quad`` gives (see the kernel source for
the design: a warp per hypothesis over the valid beams, staged once per
block in shared memory). ``interp_moments`` launches the kernel for CUDA
tensors and runs ``interp_moments_plain`` only for CPU tensors; there is
no fallback from one to the other.

``interp_moments_level`` runs a whole pyramid level of the batched
matcher: every GN step's moments, guard, solve, clamp and pose update in
ONE launch of the kernel's level form, bit-equal to one ``interp_moments``
launch a step with ``core/matcher.guarded_step`` between them (its plain
loop on CPU tensors).

The JAX module's granular repair (``_first_k_indices``,
``bad_query_corrections``, ``_moment_corrections``,
``hector_slam_tpu/ops/pallas_interp.py:439-531``) is plain tensor code
and lives here too: the kernel needs no repair, but the one-hot matcher
(parallel/onehot_match.py) repairs its patch-overflow queries with it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..core.interp import assemble_hessian, interp_quad, normal_eqs_quad
from ..core.matcher import guarded_step
from . import cuda_build

_OUT = 10   # 9 moments + used count per hypothesis
MAX_POINTS = 28672   # beams one block stages in shared memory (224 KB)


class Moments(NamedTuple):
    hess: torch.Tensor   # f32[B, 3, 3]
    dtr: torch.Tensor    # f32[B, 3]
    used: torch.Tensor   # f32[B] in-bounds valid queries per hypothesis


def interp_moments_plain(
    quad: torch.Tensor,        # f32[H*W, 4] quad-packed prob grid
    shape: Tuple[int, int],
    poses_map: torch.Tensor,   # f32[B, 3] map-frame poses
    points: torch.Tensor,      # f32[N, 2] beam endpoints (map scale)
    mask: torch.Tensor,        # bool[N]
) -> Moments:
    """The kernel's function in batched torch ops: a gather of quad[idx]
    into [B, N, 4] and sums over the beam axis."""
    return Moments(*normal_eqs_quad(quad, shape, poses_map, points, mask))


def _check(quad, shape, poses_map, points, mask, what="interp_moments"):
    h, w = shape
    dev = quad.device
    for name, t, dtype, want in (
            ("quad", quad, torch.float32, (h * w, 4)),
            ("poses_map", poses_map, torch.float32, (poses_map.shape[0], 3)),
            ("points", points, torch.float32, (points.shape[0], 2)),
            ("mask", mask, torch.bool, (points.shape[0],))):
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"quad on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if h < 2 or w < 2:
        raise ValueError(f"{what}: grid {shape} is smaller than 2x2")
    if h * w > 2 ** 31 - 1:
        raise ValueError(f"{what}: grid {shape} has more than "
                         "2^31 - 1 cells (the kernel indexes them as i32)")
    if points.shape[0] > MAX_POINTS:
        raise ValueError(f"{what}: {points.shape[0]} beams, the "
                         f"kernel stages at most {MAX_POINTS}")
    if quad.data_ptr() % 16 or points.data_ptr() % 8:
        raise ValueError(f"{what}: quad must be 16-byte and points "
                         "8-byte aligned")


# each C entry point's arguments: p a pointer (or the stream), i an int
_ARGTYPES = {"hs_interp_moments": "piipppippipp",
             "hs_interp_moments_level": "piipippiippp"}


def _library(entry="hs_interp_moments"):
    fn = getattr(cuda_build.load("interp_moments"), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                       for k in _ARGTYPES[entry]]
        fn.restype = ctypes.c_int
    return fn


def _launch(quad, shape, poses_map, sin_t, cos_t, points, mask, out):
    """The bare kernel launch on checked, prepared CUDA buffers (``out``
    f32[B, 10]), counted in ``interp_moments.launches``; raises if the
    launch is refused. Callers other than ``interp_moments`` time the
    kernel with it."""
    with torch.cuda.device(quad.device):
        rc = _library()(quad.data_ptr(), shape[0], shape[1],
                        poses_map.data_ptr(), sin_t.data_ptr(),
                        cos_t.data_ptr(), poses_map.shape[0],
                        points.data_ptr(), mask.data_ptr(), points.shape[0],
                        out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"interp_moments: kernel launch failed with CUDA "
                           f"error {rc}")
    interp_moments.launches += 1


def prepare(quad, shape, poses_map, points, mask):
    """Checks the inputs and returns the launch buffers (sin, cos, out):
    sin/cos exactly as the plain version computes them, so both see the
    same f32 inputs."""
    _check(quad, shape, poses_map, points, mask)
    sin_t = torch.sin(poses_map[:, 2]).contiguous()
    cos_t = torch.cos(poses_map[:, 2]).contiguous()
    out = torch.empty((poses_map.shape[0], _OUT), dtype=torch.float32,
                      device=quad.device)
    return sin_t, cos_t, out


def interp_moments(
    quad: torch.Tensor,
    shape: Tuple[int, int],
    poses_map: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
) -> Moments:
    """Moments of every hypothesis. CPU tensors take the plain version;
    CUDA tensors launch the kernel (on the current stream) or raise."""
    if quad.device.type == "cpu":
        return interp_moments_plain(quad, shape, poses_map, points, mask)
    sin_t, cos_t, out = prepare(quad, shape, poses_map, points, mask)
    _launch(quad, shape, poses_map, sin_t, cos_t, points, mask, out)
    return Moments(assemble_hessian(*out[:, :6].unbind(-1)),
                   out[:, 6:9], out[:, 9])


interp_moments.launches = 0   # kernel launches, for chip_smoke.py


def interp_moments_level_plain(quad, shape, estimates_map, points, mask,
                               steps: int):
    """The level form's function in torch ops: ``steps`` GN steps, each
    ``interp_moments_plain`` then ``guarded_step``."""
    hess = None
    for _ in range(steps):
        mom = interp_moments_plain(quad, shape, estimates_map, points, mask)
        estimates_map = guarded_step(estimates_map, mom.hess, mom.dtr)
        hess = mom.hess
    return estimates_map, hess


def interp_moments_level(
    quad: torch.Tensor,            # f32[H*W, 4] quad-packed prob grid
    shape: Tuple[int, int],
    estimates_map: torch.Tensor,   # f32[B, 3] map-frame start estimates
    points: torch.Tensor,          # f32[N, 2] the level's beam endpoints
    mask: torch.Tensor,            # bool[N]
    steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` guarded GN steps of every hypothesis on one pyramid level.
    Returns (estimates_map f32[B, 3] after the last step, hess f32[B, 3, 3]
    summed at the last step's start estimate). CUDA tensors launch the
    kernel's level form once (on the current stream) or raise; CPU tensors
    run ``interp_moments_level_plain``. Both check their inputs as
    ``interp_moments``' kernel route does."""
    if int(steps) != steps or steps < 1:
        raise ValueError(f"interp_moments_level: steps must be a positive "
                         f"integer, got {steps}")
    _check(quad, shape, estimates_map, points, mask, "interp_moments_level")
    if quad.device.type == "cpu":
        return interp_moments_level_plain(quad, shape, estimates_map, points,
                                          mask, int(steps))
    b = estimates_map.shape[0]
    est = torch.empty((b, 3), dtype=torch.float32, device=quad.device)
    hess = torch.empty((b, 3, 3), dtype=torch.float32, device=quad.device)
    with torch.cuda.device(quad.device):
        rc = _library("hs_interp_moments_level")(
            quad.data_ptr(), shape[0], shape[1], estimates_map.data_ptr(), b,
            points.data_ptr(), mask.data_ptr(), points.shape[0], int(steps),
            est.data_ptr(), hess.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"interp_moments_level: kernel launch failed "
                           f"with CUDA error {rc}")
    interp_moments_level.launches += 1
    return est, hess


interp_moments_level.launches = 0   # level-form launches (core/graphs.py)


# ---- the granular repair of a fast path's left-out queries -----------------


def _first_k_indices(flat: torch.Tensor, k: int):
    """Flat indices of the first ``k`` True elements of a bool vector, by
    two-level compaction: per-128-block popcounts, a cumsum over the
    block counts, a left-side searchsorted placing each rank in its
    block, then an in-block cumsum whose first hit of the rank is the
    column. Returns (idx i32[k], valid bool[k], total i32[]). Ranks past
    the total are not valid; their indices are in [0, len rounded up to
    128) and mean nothing."""
    pad = (-flat.shape[0]) % 128
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, 128)
    m = blocks.shape[0]
    cnt = blocks.sum(dim=1, dtype=torch.int32)             # [M]
    cpos = torch.cumsum(cnt, 0, dtype=torch.int32)
    total = cpos[-1]
    j = torch.arange(1, k + 1, dtype=torch.int32, device=flat.device)
    mb = torch.clamp(torch.searchsorted(cpos, j, out_int32=True),
                     max=m - 1)                            # block of rank j
    before = torch.where(mb > 0, cpos[torch.clamp(mb - 1, min=0).long()],
                         0)
    rank = j - before                                      # 1-based in block
    rows = blocks[mb.long()].to(torch.int32)               # [k, 128]
    rcum = torch.cumsum(rows, 1, dtype=torch.int32)
    # argmax returns the first maximum: the first column reaching the rank
    col = torch.argmax((rcum == rank[:, None]).to(torch.uint8), dim=1)
    idx = mb * 128 + col.to(torch.int32)
    return idx, j <= total, total


def bad_query_corrections(
    quad: torch.Tensor,        # f32[H*W, 4] quad-packed prob grid
    shape: Tuple[int, int],
    tx: torch.Tensor,          # f32[B, N] map-frame query coords
    ty: torch.Tensor,
    sin_t: torch.Tensor,       # f32[B]
    cos_t: torch.Tensor,
    points: torch.Tensor,      # f32[N, 2]
    bad: torch.Tensor,         # bool[B, N] queries to re-evaluate
    k_budget: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact moment contributions of the ``bad`` queries: budgeted
    compaction, a quad gather each, and a per-hypothesis sum. Returns
    (h_corr f32[B, 3, 3], d_corr f32[B, 3]) to add to a fast path that
    left those queries out. Only the first ``k_budget`` bad queries are
    covered: callers check ``bad.sum() <= k_budget`` and take the full
    path otherwise."""
    b_total, n = tx.shape
    flat_idx, valid, _ = _first_k_indices(bad.reshape(-1), k_budget)
    flat_idx = flat_idx.long()
    b_i = flat_idx // n
    n_i = flat_idx % n
    # an invalid rank's index may lie past the queries (the block
    # padding); JAX's gather clamps it, and its terms are zeroed
    q = torch.clamp(flat_idx, max=b_total * n - 1)
    txq = tx.reshape(-1)[q]
    tyq = ty.reshape(-1)[q]
    return _moment_corrections(quad, shape, txq, tyq, sin_t, cos_t, points,
                               b_i, n_i, valid, b_total)


def _moment_corrections(quad, shape, txq, tyq, sin_t, cos_t, points,
                        b_i, n_i, valid, b_total):
    """The repair's tail: exact quad-gather moment contributions of K
    compacted queries, summed into their hypotheses' 3x3 H and dTr.

    JAX sums them with ``segment_sum``, a scatter-add; on the card a
    scatter-add adds by atomics in no fixed order. Compaction leaves the
    valid queries first, hypothesis-major and ascending, so each
    hypothesis's terms are one contiguous run, summed here by a
    segmented scan of elementwise steps (``_run_sums``): one order on
    every device and every call."""
    m, gx, gy = interp_quad(quad, shape, torch.stack([txq, tyq], dim=-1))
    pxq = points[n_i, 0]
    pyq = points[n_i, 1]
    b_q = torch.clamp(b_i, max=b_total - 1)
    s_q = sin_t[b_q]
    c_q = cos_t[b_q]
    rot = (-s_q * pxq - c_q * pyq) * gx + (c_q * pxq - s_q * pyq) * gy
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    m = torch.where(valid, m, zero)
    gx = torch.where(valid, gx, zero)
    gy = torch.where(valid, gy, zero)
    rot = torch.where(valid, rot, zero)
    fun = torch.where(valid, 1.0 - m, zero)
    terms = torch.stack([gx * gx, gx * gy, gx * rot,
                         gy * gy, gy * rot, rot * rot,
                         gx * fun, gy * fun, rot * fun], dim=-1)  # [K, 9]
    # the invalid ranks (a suffix) form one run past the last hypothesis
    corr = _run_sums(terms, torch.where(valid, b_i, b_total), b_total)
    return assemble_hessian(*corr[:, :6].unbind(-1)), corr[:, 6:9]


def _run_sums(terms: torch.Tensor, seg: torch.Tensor,
              num_segments: int) -> torch.Tensor:
    """Sums of ``terms`` [K, C] over each run of equal ``seg`` (i64[K],
    non-decreasing) -> f32[num_segments, C]; segments with no term get
    +0. A Hillis-Steele segmented inclusive scan (log2 K elementwise
    steps) leaves each run's sum on its last element."""
    k = terms.shape[0]
    if k == 0:
        return terms.new_zeros((num_segments, terms.shape[1]))
    d = 1
    while d < k:
        same = (seg[d:] == seg[:-d])[:, None]
        terms = torch.cat([terms[:d], torch.where(
            same, terms[d:] + terms[:-d], terms[d:])])
        d *= 2
    ids = torch.arange(num_segments, dtype=seg.dtype, device=seg.device)
    last = torch.clamp(torch.searchsorted(seg, ids, right=True) - 1, min=0)
    has = seg[last] == ids
    return torch.where(has[:, None], terms[last],
                       torch.zeros((), dtype=terms.dtype,
                                   device=terms.device))
