"""Sum of dynamic-offset patch loads: the CUDA kernel ``csrc/dyn_slice.cu``
and its plain PyTorch version.

Replaces the Pallas TPU probe ``tools/probe_pallas.py:dyn_slice``: per
rep ``i``, ``acc += g[y0 : y0+ph, x0 : x0+pw]`` at the offsets of table
slot ``i mod 512``. Mode ``"y"`` takes x0 = 0, ``"xal"`` floors x to a
multiple of ``pw``, ``"both"`` takes x as it is. A start outside the grid
is resolved as the probe resolves it (``resolve_offsets``): a negative
start is wrapped once by the dimension, then clamped to
``[0, dim - patch]``.

``dyn_slice`` launches the kernel for CUDA tensors and runs
``dyn_slice_plain`` only for CPU tensors; there is no fallback from one to
the other. The kernel stages each warp's 512 table slots in shared memory
(see its source), which it can do for every patch that fits the grid.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build

MODES = ("y", "xal", "both")
OFFSETS = 512   # the probe's offset table, read at rep i mod 512


def resolve_offsets(ys: torch.Tensor, xs: torch.Tensor,
                    shape: Tuple[int, int], patch: Tuple[int, int],
                    mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The patch starts (y0, x0) the probe loads for the table (ys, xs):
    a negative start wrapped once by the dimension, then clamped to
    [0, dim - patch]."""
    if mode not in MODES:
        raise ValueError(f"dyn_slice: mode {mode!r} is not one of {MODES}")
    (gh, gw), (ph, pw) = shape, patch
    y0 = torch.where(ys < 0, ys + gh, ys).clamp(0, gh - ph)
    if mode == "y":
        return y0, torch.zeros_like(xs)
    x = xs if mode == "both" else torch.div(xs, pw, rounding_mode="floor") * pw
    return y0, torch.where(x < 0, x + gw, x).clamp(0, gw - pw)


def dyn_slice_plain(g: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    reps: int, patch: Tuple[int, int] = (32, 128),
                    mode: str = "both") -> torch.Tensor:
    """The kernel's function in torch ops: one slice and one add per rep,
    in loop order."""
    ph, pw = patch
    y0, x0 = resolve_offsets(ys, xs, tuple(g.shape), patch, mode)
    y0, x0 = y0.tolist(), x0.tolist()
    acc = torch.zeros(patch, dtype=torch.float32, device=g.device)
    for i in range(reps):
        j = i % OFFSETS
        acc = acc + g[y0[j]:y0[j] + ph, x0[j]:x0[j] + pw]
    return acc


def _check(g, ys, xs, reps, patch, mode):
    (gh, gw), (ph, pw) = g.shape, patch
    if g.dtype != torch.float32 or ys.dtype != torch.int32 \
            or xs.dtype != torch.int32:
        raise TypeError("dyn_slice: g must be float32, ys and xs int32")
    if g.dim() != 2 or ys.shape != (OFFSETS,) or xs.shape != (OFFSETS,):
        raise ValueError(f"dyn_slice: g must be 2-D and ys, xs i32"
                         f"[{OFFSETS}]; got {tuple(g.shape)}, "
                         f"{tuple(ys.shape)}, {tuple(xs.shape)}")
    if ys.device != g.device or xs.device != g.device:
        raise ValueError("dyn_slice: ys and xs must be on g's device")
    if not (g.is_contiguous() and ys.is_contiguous() and xs.is_contiguous()):
        raise ValueError("dyn_slice: g, ys and xs must be contiguous")
    if mode not in MODES:
        raise ValueError(f"dyn_slice: mode {mode!r} is not one of {MODES}")
    if not (0 < ph <= gh and 0 < pw <= gw) or gh * gw >= 2 ** 31:
        raise ValueError(f"dyn_slice: patch {patch} does not fit the grid "
                         f"{tuple(g.shape)} (or the grid has 2^31 cells)")
    if reps < 0:
        raise ValueError(f"dyn_slice: reps={reps} < 0")


def _library():
    lib = cuda_build.load("dyn_slice")
    fn = lib.hs_dyn_slice
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def dyn_slice(g: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
              reps: int, patch: Tuple[int, int] = (32, 128),
              mode: str = "both") -> torch.Tensor:
    """f32[ph, pw]: the sum of ``reps`` patches of the f32 grid ``g`` at
    the offsets of the i32[512] tables ``ys``/``xs``. CPU tensors take the
    plain version; CUDA tensors launch the kernel (on the current stream)
    or raise."""
    if g.device.type == "cpu":
        return dyn_slice_plain(g, ys, xs, reps, patch, mode)
    _check(g, ys, xs, reps, patch, mode)
    out = torch.empty(patch, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = _library()(g.data_ptr(), g.shape[0], g.shape[1], ys.data_ptr(),
                        xs.data_ptr(), int(reps), patch[0], patch[1],
                        MODES.index(mode), out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dyn_slice: kernel launch failed with CUDA "
                           f"error {rc}")
    dyn_slice.launches += 1
    return out


dyn_slice.launches = 0   # kernel launches, for chip_smoke.py
