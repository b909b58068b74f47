"""Chained take-along-axis over the tiles of an operand: the CUDA kernel
``csrc/take_along.cu`` and its plain PyTorch version.

Replaces the Pallas TPU probes ``tools/probe_pallas.py:gather_tiles`` and
``gather_big``; the second is the first with one tile
(``tile_rows = p.shape[0]``). Per rep ``i`` every tile ``t`` gathers
``p[t] + acc[0] * 1e-30`` along ``axis`` at ``(idx[t] + i) mod`` the
axis length and adds it to ``acc[t]``, where ``acc[0]`` is the first
tile's accumulator of the rep before (see the kernel source for the
design).

``take_along`` launches the kernel for CUDA tensors and runs
``take_along_plain`` only for CPU tensors; there is no fallback from one
to the other. ``idx + reps`` must stay inside int32, as in the probe. The
kernel holds one line of the gathered axis (a row on axis 1, a column on
axis 0) on one SM: in one warp up to 256 positions, in one block's shared
memory beyond that. So that axis is at most ``MAX_LINE`` long, on the CPU
as on the card (``_check`` runs first on both); the tile may have any
number of lines. A longer line is the one input that the TPU probe in
interpret mode computes and the port refuses: the TPU kernel, too, holds
its whole operand in fast memory (``BlockSpec(memory_space=VMEM)``,
``tools/probe_pallas.py:119``), so a line past what the card's shared
memory holds is past what the probe was built for.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

MAX_LINE = 8192   # the gathered axis: 28 bytes a position of one block's
#                  shared memory (csrc/take_along.cu kMaxLine)


def _tiling(p: torch.Tensor, tile_rows: Optional[int]):
    rows, tw = p.shape
    th = rows if tile_rows is None else int(tile_rows)
    if th <= 0 or rows % th:
        raise ValueError(f"take_along: tile_rows={th} does not divide "
                         f"{rows} rows")
    return rows // th, th, tw


def take_along_plain(p: torch.Tensor, idx: torch.Tensor, reps: int,
                     axis: int, tile_rows: Optional[int] = None
                     ) -> torch.Tensor:
    """The kernel's function in torch ops: f32[T*th, tw], one
    ``take_along_dim`` over all tiles per rep."""
    tiles, th, tw = _tiling(p, tile_rows)
    mod = tw if axis == 1 else th
    pt = p.reshape(tiles, th, tw)
    it = idx.reshape(tiles, th, tw)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=p.device)
    acc = torch.zeros_like(pt)
    for i in range(reps):
        ix = torch.remainder(it + i, mod).to(torch.int64)
        acc = acc + torch.take_along_dim(pt + acc[0] * tiny, ix, dim=axis + 1)
    return acc.reshape(p.shape)


def _check(p, idx, reps, axis, tile_rows):
    if p.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"take_along: p must be float32 and idx int32, got "
                        f"{p.dtype} and {idx.dtype}")
    if p.dim() != 2 or idx.shape != p.shape:
        raise ValueError(f"take_along: p {tuple(p.shape)} and idx "
                         f"{tuple(idx.shape)} must be one 2-D shape")
    if idx.device != p.device:
        raise ValueError(f"take_along: idx is on {idx.device}, p on "
                         f"{p.device}")
    if not (p.is_contiguous() and idx.is_contiguous()):
        raise ValueError("take_along: p and idx must be contiguous")
    if axis not in (0, 1):
        raise ValueError(f"take_along: axis must be 0 or 1, got {axis}")
    if reps < 0:
        raise ValueError(f"take_along: reps={reps} < 0")
    tiles, th, tw = _tiling(p, tile_rows)
    line = tw if axis == 1 else th
    if line > MAX_LINE:
        raise ValueError(f"take_along: a {th}x{tw} tile gathers along "
                         f"{line} positions on axis {axis}; a line holds "
                         f"at most {MAX_LINE}")
    return tiles, th, tw


def _library():
    lib = cuda_build.load("take_along")
    fn = lib.hs_take_along
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def take_along(p: torch.Tensor, idx: torch.Tensor, reps: int, axis: int,
               tile_rows: Optional[int] = None) -> torch.Tensor:
    """f32[T*th, tw] after ``reps`` chained gathers along ``axis`` of the
    f32 operand ``p`` at the i32 indices ``idx`` (one shape), in tiles of
    ``tile_rows`` rows (default: one tile). CPU tensors take the plain
    version; CUDA tensors launch the kernel (on the current stream) or
    raise. Both are checked first (``_check``)."""
    tiles, th, tw = _check(p, idx, reps, axis, tile_rows)
    if p.device.type == "cpu":
        return take_along_plain(p, idx, reps, axis, tile_rows)
    out = torch.empty_like(p)
    with torch.cuda.device(p.device):
        rc = _library()(p.data_ptr(), idx.data_ptr(), out.data_ptr(), tiles,
                        th, tw, int(reps), axis,
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"take_along: kernel launch failed with CUDA "
                           f"error {rc}")
    take_along.launches += 1
    return out


take_along.launches = 0   # kernel launches, for chip_smoke.py
