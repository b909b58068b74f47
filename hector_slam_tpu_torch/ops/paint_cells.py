"""Scatter-OR of flat cell indices into a boolean grid: the CUDA kernel
``csrc/paint_cells.cu`` and its plain PyTorch version.

Replaces the Pallas TPU probe ``tools/probe_mosaic_store.py:
probe_scalar_store`` (zero a grid, store 1 at every listed cell), which is
the map update's ``_scatter_true`` (``hector_slam_tpu/core/mapping.py:
155-160``, left to XLA's scatter on the TPU). Every free and occupied
cell set of every map update goes through ``paint_cells``: six paints
per gated scan (three levels, free and occupied), and one paint per set
and level for a whole fleet.

``paint_cells`` launches the kernel for CUDA tensors and runs
``paint_cells_plain`` only for CPU tensors; there is no fallback from one
to the other. Both drop every index outside ``[0, num_cells)``, the map
update's sentinel ``num_cells`` among them (JAX ``mode="drop"``).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_MAX_CELLS = 2 ** 31 - 1   # the kernel compares indices as u32 against i32


def paint_cells_plain(flat: torch.Tensor, num_cells: int) -> torch.Tensor:
    """The kernel's function in torch ops: ``index_put_`` into a grid of
    ``num_cells + 1`` slots, whose last slot takes every dropped index
    and is sliced off (``index_put_`` has no drop mode)."""
    idx = flat.reshape(-1).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < num_cells), idx, num_cells)
    out = torch.zeros(num_cells + 1, dtype=torch.bool, device=flat.device)
    out[idx] = True
    return out[:-1]


def _check(flat: torch.Tensor, num_cells: int) -> None:
    if flat.dtype != torch.int32:
        raise TypeError(f"paint_cells: indices must be torch.int32, got "
                        f"{flat.dtype}")
    if not flat.is_contiguous():
        raise ValueError("paint_cells: indices must be contiguous")
    if not 0 < num_cells <= _MAX_CELLS:
        raise ValueError(f"paint_cells: num_cells={num_cells} outside "
                         f"(0, {_MAX_CELLS}]")


def _library():
    lib = cuda_build.load("paint_cells")
    fn = lib.hs_paint_cells
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, p, ctypes.c_uint, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(flat: torch.Tensor, grid: torch.Tensor) -> None:
    """The bare kernel launch on checked CUDA buffers: stores 1 into the
    bool ``grid`` (1 byte per cell) at every in-range index of ``flat``;
    raises if the launch is refused. Counted in ``paint_cells.launches``:
    callers other than ``paint_cells`` time the kernel with it."""
    if grid.dtype != torch.bool or not grid.is_contiguous() \
            or grid.device != flat.device:
        raise ValueError("paint_cells: the grid must be a contiguous bool "
                         "tensor on the indices' device")
    with torch.cuda.device(flat.device):
        rc = _library()(flat.data_ptr(), flat.numel(), grid.data_ptr(),
                        grid.numel(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paint_cells: kernel launch failed with CUDA "
                           f"error {rc}")
    paint_cells.launches += 1


def paint_cells(flat: torch.Tensor, num_cells: int) -> torch.Tensor:
    """bool[num_cells]: False everywhere except at the cells listed in the
    i32 index tensor ``flat`` (any shape). CPU tensors take the plain
    version; CUDA tensors launch the kernel (on the current stream) or
    raise."""
    if flat.device.type == "cpu":
        return paint_cells_plain(flat, num_cells)
    _check(flat, num_cells)
    grid = torch.zeros(num_cells, dtype=torch.bool, device=flat.device)
    _launch(flat, grid)
    return grid


paint_cells.launches = 0   # kernel launches, for chip_smoke.py
