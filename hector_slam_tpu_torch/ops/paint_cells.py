"""Scatter-OR of flat cell indices into boolean grids: the CUDA kernel
``csrc/paint_cells.cu`` and its plain PyTorch version.

Replaces the Pallas TPU probe ``tools/probe_mosaic_store.py:
probe_scalar_store`` (zero a grid, store 1 at every listed cell), which is
the map update's ``_scatter_true`` (``hector_slam_tpu/core/mapping.py:
155-160``, left to XLA's scatter on the TPU). A map update paints all its
free and occupied cell sets, every level's, with one ``paint_cell_sets``
call: one zero fill and one kernel launch, for one scan or a whole fleet.
``paint_cells`` is the one-set table.

The wrappers launch the kernel for CUDA tensors and run the plain version
only for CPU tensors; there is no fallback from one to the other. Both
drop every index outside ``[0, num_cells)``, the map update's sentinel
``num_cells`` among them (JAX ``mode="drop"``).
"""

from __future__ import annotations

import ctypes
import itertools
from typing import List, Sequence

import torch

from . import cuda_build

_MAX_CELLS = 2 ** 31 - 1   # the kernel compares indices as u32 against i32
MAX_SETS = 8               # sets per launch (kMaxSets in the kernel)


def paint_cells_plain(flat: torch.Tensor, num_cells: int) -> torch.Tensor:
    """The kernel's function in torch ops: ``index_put_`` into a grid of
    ``num_cells + 1`` slots, whose last slot takes every dropped index
    and is sliced off (``index_put_`` has no drop mode)."""
    idx = flat.reshape(-1).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < num_cells), idx, num_cells)
    out = torch.zeros(num_cells + 1, dtype=torch.bool, device=flat.device)
    out[idx] = True
    return out[:-1]


def paint_cell_sets_plain(flats: Sequence[torch.Tensor],
                          sizes: Sequence[int]) -> List[torch.Tensor]:
    """``paint_cell_sets`` in torch ops: ``paint_cells_plain`` per set."""
    return [paint_cells_plain(f, n) for f, n in zip(flats, sizes)]


def _check(flats: Sequence[torch.Tensor], sizes: Sequence[int]) -> None:
    if len(flats) != len(sizes) or not flats:
        raise ValueError(f"paint_cells: {len(flats)} index tensors for "
                         f"{len(sizes)} grids")
    for flat, num_cells in zip(flats, sizes):
        if flat.dtype != torch.int32:
            raise TypeError(f"paint_cells: indices must be torch.int32, got "
                            f"{flat.dtype}")
        if not flat.is_contiguous():
            raise ValueError("paint_cells: indices must be contiguous")
        if flat.device != flats[0].device:
            raise ValueError("paint_cells: every index tensor must be on one "
                             "device")
        if not 0 < num_cells <= _MAX_CELLS:
            raise ValueError(f"paint_cells: num_cells={num_cells} outside "
                             f"(0, {_MAX_CELLS}]")


def _offsets(sizes: Sequence[int]) -> List[int]:
    """Each grid's byte offset in the one buffer, and its total size
    last."""
    return list(itertools.accumulate(sizes, initial=0))


def _library():
    lib = cuda_build.load("paint_cells")
    fn = lib.hs_paint_cell_sets
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(flats: Sequence[torch.Tensor], sizes: Sequence[int],
            buf: torch.Tensor) -> None:
    """The bare kernel launches on checked CUDA buffers: stores 1 into the
    bool ``buf`` (1 byte per cell, grids at ``_offsets(sizes)``) at every
    in-range index of each set; one launch per ``MAX_SETS`` sets, none if
    every set is empty. Raises if a launch is refused. Counted in
    ``paint_cells.launches``: callers other than the wrappers time the
    kernel with it."""
    offs = _offsets(sizes)
    if buf.dtype != torch.bool or not buf.is_contiguous() \
            or buf.device != flats[0].device or buf.numel() < offs[-1]:
        raise ValueError("paint_cells: the grid buffer must be a contiguous "
                         f"bool tensor of >= {offs[-1]} cells on the indices' "
                         "device")
    fn = _library()
    for lo in range(0, len(flats), MAX_SETS):
        part = range(lo, min(lo + MAX_SETS, len(flats)))
        if not any(flats[k].numel() for k in part):
            continue
        k_n = len(part)
        idx = (ctypes.c_void_p * k_n)(*[flats[k].data_ptr() for k in part])
        n = (ctypes.c_longlong * k_n)(*[flats[k].numel() for k in part])
        grid = (ctypes.c_void_p * k_n)(*[buf.data_ptr() + offs[k]
                                         for k in part])
        cells = (ctypes.c_uint * k_n)(*[sizes[k] for k in part])
        with torch.cuda.device(buf.device):
            rc = fn(k_n, idx, n, grid, cells,
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"paint_cells: kernel launch failed with CUDA "
                               f"error {rc}")
        paint_cells.launches += 1


def paint_cell_sets(flats: Sequence[torch.Tensor],
                    sizes: Sequence[int]) -> List[torch.Tensor]:
    """bool[sizes[k]] per set k: False everywhere except at the cells
    listed in the i32 index tensor ``flats[k]`` (any shape). The grids
    are views into one buffer, zeroed by one fill and painted by one
    kernel launch (per ``MAX_SETS`` sets). CPU tensors take the plain
    version; CUDA tensors launch the kernel (on the current stream) or
    raise."""
    _check(flats, sizes)
    if flats[0].device.type == "cpu":
        return paint_cell_sets_plain(flats, sizes)
    flats = [f.reshape(-1) for f in flats]
    offs = _offsets(sizes)
    buf = torch.zeros(offs[-1], dtype=torch.bool, device=flats[0].device)
    _launch(flats, sizes, buf)
    return [buf[o:o + n] for o, n in zip(offs, sizes)]


def paint_cells(flat: torch.Tensor, num_cells: int) -> torch.Tensor:
    """bool[num_cells]: False everywhere except at the cells listed in the
    i32 index tensor ``flat`` (any shape); ``paint_cell_sets`` of one
    set."""
    return paint_cell_sets([flat], [num_cells])[0]


paint_cells.launches = 0   # kernel launches, for chip_smoke.py
