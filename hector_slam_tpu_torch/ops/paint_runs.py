"""Run painting into a zeroed grid: the CUDA kernel ``csrc/paint_runs.cu``
(one launch that zeroes the grid and paints the runs) and its plain
PyTorch version.

Replaces the Pallas TPU probe ``tools/probe_mosaic_store.py:
probe_run_store`` (design B of that probe): per run, lanes ``lo..hi`` of
the aligned [1, 128] row segment at ``(row, c0)`` are set to 1.0, that is
``grid[row, c0+lo : c0+hi+1] = 1``. Every store writes the same value, so
the result is exact and does not depend on the order of the runs.

Both versions check the TPU kernel's precondition on the host first:
``c0`` a multiple of 128, ``0 <= lo <= hi < 128``, and the segment inside
the grid. ``paint_runs`` launches the kernel for CUDA tensors and runs
``paint_runs_plain`` only for CPU tensors; there is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build

LANES = 128   # the [1, 128] segment of the TPU kernel


def check_runs(rows, c0, lo, hi, shape: Tuple[int, int]) -> None:
    """Raises unless the runs meet the TPU kernel's precondition (one host
    synchronisation for CUDA tensors)."""
    h, w = shape
    runs = (rows, c0, lo, hi)
    if any(t.dtype != torch.int32 for t in runs):
        raise TypeError("paint_runs: rows, c0, lo and hi must be int32")
    if any(t.dim() != 1 or t.shape != rows.shape or t.device != rows.device
           or not t.is_contiguous() for t in runs):
        raise ValueError("paint_runs: rows, c0, lo and hi must be contiguous "
                         "1-D tensors of one length on one device")
    if not (0 < h and 0 < w and h * w < 2 ** 31):
        raise ValueError(f"paint_runs: grid {shape} is empty or has 2^31 "
                         f"cells")
    bad = ((rows < 0) | (rows >= h) | (c0 < 0) | (c0 + LANES > w)
           | (c0 % LANES != 0) | (lo < 0) | (lo > hi) | (hi >= LANES))
    if bool(bad.any()):
        i = int(bad.nonzero()[0])
        raise ValueError(
            f"paint_runs: run {i} (row {int(rows[i])}, c0 {int(c0[i])}, lo "
            f"{int(lo[i])}, hi {int(hi[i])}) breaks the precondition: c0 a "
            f"multiple of {LANES} with c0 + {LANES} <= {w}, 0 <= row < {h}, "
            f"0 <= lo <= hi < {LANES}")


def paint_runs_plain(rows: torch.Tensor, c0: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, shape: Tuple[int, int]
                     ) -> torch.Tensor:
    """The kernel's function in torch ops: a [runs, 128] lane mask and
    one ``index_put_`` of 1.0 at every masked cell."""
    check_runs(rows, c0, lo, hi, shape)
    lanes = torch.arange(LANES, dtype=torch.int64, device=rows.device)
    mask = (lanes >= lo[:, None]) & (lanes <= hi[:, None])
    flat = (rows.to(torch.int64) * shape[1] + c0.to(torch.int64))[:, None] \
        + lanes
    grid = torch.zeros(shape, dtype=torch.float32, device=rows.device)
    grid.view(-1)[flat[mask]] = 1.0
    return grid


def _library():
    lib = cuda_build.load("paint_runs")
    fn = lib.hs_paint_runs
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(rows, c0, lo, hi, grid) -> None:
    """The bare kernel launch on checked CUDA buffers: zeroes the f32
    ``grid`` (whatever it held) and paints the runs into it, counted in
    ``paint_runs.launches``; raises if the launch is refused. Callers
    other than ``paint_runs`` time the kernel with it, without the host
    check."""
    if grid.dtype != torch.float32 or grid.dim() != 2 \
            or not grid.is_contiguous() or grid.device != rows.device \
            or grid.data_ptr() % 16:
        raise ValueError("paint_runs: the grid must be a contiguous, "
                         "16-byte aligned 2-D f32 tensor on the runs' device")
    with torch.cuda.device(grid.device):
        rc = _library()(rows.data_ptr(), c0.data_ptr(), lo.data_ptr(),
                        hi.data_ptr(), rows.numel(), grid.data_ptr(),
                        grid.shape[0], grid.shape[1],
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paint_runs: kernel launch failed with CUDA "
                           f"error {rc}")
    paint_runs.launches += 1


def paint_runs(rows: torch.Tensor, c0: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """f32[H, W]: zero everywhere except ``grid[row, c0+lo : c0+hi+1] = 1``
    for every run of the i32 tensors ``rows``, ``c0``, ``lo``, ``hi``. CPU
    tensors take the plain version; CUDA tensors launch the kernel (on the
    current stream) or raise."""
    if rows.device.type == "cpu":
        return paint_runs_plain(rows, c0, lo, hi, shape)
    check_runs(rows, c0, lo, hi, shape)
    grid = torch.empty(shape, dtype=torch.float32, device=rows.device)
    _launch(rows, c0, lo, hi, grid)
    return grid


paint_runs.launches = 0   # kernel launches, for chip_smoke.py
