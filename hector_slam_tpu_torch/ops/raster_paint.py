"""The map update's rasterization and paint in one launch: the CUDA kernel
``csrc/raster_paint.cu`` and its plain PyTorch version.

``raster_paint`` paints one update's free and occupied cell sets, every
level's and every scan's, straight from the scans: each beam's Bresenham
cells (``core/mapping.py``'s closed form, the reference's rounding and
validity rules) are stored into zeroed bool grids, with no index set in
device memory, and each scan's cells past a level's ``max_ray_cells``
are counted. It replaces, on the card, the index sets that
``core/mapping.py`` builds in torch ops (``cell_indices``,
``seg_cell_indices``) together with their ``paint_cell_sets`` launch
(``ops/paint_cells.py``, which replaces the Pallas probe
``tools/probe_mosaic_store.py: probe_scalar_store``).

The wrapper launches the kernel for CUDA tensors (one zero fill and one
launch an update) and runs ``raster_paint_plain``, the torch route of the
dense index sets and ``paint_cell_sets_plain``, only for CPU tensors;
there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from .paint_cells import paint_cell_sets_plain

MAX_LEVELS = 8       # levels of one update (kMaxLevels in the kernel)
MAX_SCANS = 65535    # scans per launch (the grid's y)
_MAX_CELLS = 2 ** 31 - 1   # the kernel indexes a level's grids as i32


class RasterLevel(NamedTuple):
    """One level's raster geometry."""

    shape: Tuple[int, int]          # (H, W) of the level's grid
    point_scale: float              # level_points' 2^-level (1: as given)
    offset: Tuple[float, float]     # MapConfig.top_left_offset
    scale: float                    # world -> map (MapConfig.level_scale)
    max_ray_cells: int              # free cells painted per beam at most


class RasterSets(NamedTuple):
    """What an update paints: each level's (free, occupied) bool grids,
    ``([R,] H, W)``, and the truncated cells, i32 ``[levels, (R,)]`` per
    level and ``[(R,)]`` summed over levels."""

    sets: List[Tuple[torch.Tensor, torch.Tensor]]
    level_truncated: torch.Tensor
    truncated: torch.Tensor


def level_scaled(t: torch.Tensor, level: RasterLevel) -> torch.Tensor:
    """Points or origo as the level sees them: ``core/matcher.
    level_points``' scaling, by the level's ``point_scale``."""
    return t * level.point_scale if level.point_scale != 1.0 else t


def raster_paint_plain(levels: Sequence[RasterLevel], pose_world, points,
                       origo, mask, per_robot: bool = False) -> RasterSets:
    """The kernel's function in torch ops: each level's dense index sets
    (``core/mapping.cell_indices``) painted by ``paint_cell_sets_plain``,
    the truncated counts summed over levels as ``paint_pyramid`` sums
    them."""
    from ..core.mapping import cell_indices
    sets, counts = [], []
    for lv in levels:
        free, occ, num_cells, trunc = cell_indices(
            lv.shape, pose_world, level_scaled(points, lv),
            level_scaled(origo, lv), mask, lv.offset, lv.scale,
            lv.max_ray_cells, per_robot)
        shape = (((pose_world.shape[0],) if per_robot else ())
                 + tuple(lv.shape))
        free_set, occ_set = paint_cell_sets_plain(
            [free.reshape(-1), occ.reshape(-1)], [num_cells] * 2)
        sets.append((free_set.reshape(shape), occ_set.reshape(shape)))
        counts.append(trunc)
    total = torch.zeros(pose_world.shape[:-1], dtype=torch.int32,
                        device=pose_world.device)
    for t in counts:
        total = total + t
    return RasterSets(sets, torch.stack(counts), total)


def _check(levels, pose_world, points, origo, mask, per_robot) -> int:
    """Raises on what the kernel does not take; returns the number of
    scans."""
    what = "raster_paint"
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{what}: {len(levels)} levels, 1 to {MAX_LEVELS}")
    if pose_world.dim() not in (1, 2):
        raise ValueError(f"{what}: pose must be [3] or [R, 3], got "
                         f"{tuple(pose_world.shape)}")
    lead = tuple(pose_world.shape[:-1])
    if per_robot and not lead:
        raise ValueError(f"{what}: per-robot grids take R scans (pose "
                         "[R, 3]), got one pose")
    scans = lead[0] if lead else 1
    n = points.shape[-2] if points.dim() >= 2 else -1
    dev = pose_world.device
    for name, t, dtype, want in (
            ("pose", pose_world, torch.float32, lead + (3,)),
            ("points", points, torch.float32, lead + (n, 2)),
            ("origo", origo, torch.float32, lead + (2,)),
            ("mask", mask, torch.bool, lead + (n,))):
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, pose on "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    if scans > MAX_SCANS:
        raise ValueError(f"{what}: {scans} scans, at most {MAX_SCANS}")
    for k, lv in enumerate(levels):
        h, w = lv.shape
        cells = h * w * (scans if per_robot else 1)
        if h < 1 or w < 1 or not cells <= _MAX_CELLS:
            raise ValueError(f"{what}: level {k}'s grids of {lv.shape} "
                             f"({cells} cells) are empty or past "
                             f"{_MAX_CELLS} cells")
        if lv.max_ray_cells < 1:
            raise ValueError(f"{what}: level {k}'s max_ray_cells is "
                             f"{lv.max_ray_cells}, at least 1")
    return scans


def _library():
    fn = cuda_build.load("raster_paint").hs_raster_paint
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 15 + [i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _f32(values) -> List[float]:
    return [float(v) for v in np.asarray(values, np.float32)]


def raster_paint(levels: Sequence[RasterLevel], pose_world: torch.Tensor,
                 points: torch.Tensor, origo: torch.Tensor,
                 mask: torch.Tensor, per_robot: bool = False) -> RasterSets:
    """Paints one update of one scan (pose f32[3], points f32[N, 2], origo
    f32[2], mask bool[N]) or of R scans (a leading R axis on each), the
    points as given in the world frame, scaled by each level's
    ``point_scale``. Every scan paints the one grid of a level, or, with
    ``per_robot``, scan r paints grid r of ``[R, H, W]``. Masked beams
    paint nothing and count no truncation. CPU tensors take the plain
    version; CUDA tensors launch the kernel (on the current stream) or
    raise."""
    scans = _check(levels, pose_world, points, origo, mask, per_robot)
    if pose_world.device.type == "cpu":
        return raster_paint_plain(levels, pose_world, points, origo, mask,
                                  per_robot)
    dev = pose_world.device
    lead = tuple(pose_world.shape[:-1])
    points, origo, mask = (t.contiguous() for t in (points, origo, mask))
    pose = pose_world.contiguous()
    if points.data_ptr() % 8:
        raise ValueError("raster_paint: points must be 8-byte aligned")
    theta = pose[..., 2]
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    # one buffer, one fill: the truncated counts (16-byte aligned), then
    # each level's free and occupied grids
    grids = scans if per_robot else 1
    sizes = [grids * lv.shape[0] * lv.shape[1] for lv in levels
             for _ in (0, 1)]
    head = -(-4 * (len(levels) + 1) * scans // 16) * 16
    offs = list(itertools.accumulate(sizes, initial=head))
    buf = torch.zeros(offs[-1], dtype=torch.uint8, device=dev)
    counts = buf[:4 * (len(levels) + 1) * scans].view(torch.int32).view(
        (len(levels) + 1,) + lead)
    flat = [buf[o:o + n].view(torch.bool) for o, n in zip(offs, sizes)]
    scales = _f32([lv.scale for lv in levels])
    off = [np.asarray(lv.offset, np.float32) * np.float32(lv.scale)
           for lv in levels]
    if points.shape[-2]:
        k_n = len(levels)

        def arr(ctype, values):
            return (ctype * k_n)(*values)

        with torch.cuda.device(dev):
            rc = _library()(
                k_n, arr(ctypes.c_void_p, [g.data_ptr() for g in flat[0::2]]),
                arr(ctypes.c_void_p, [g.data_ptr() for g in flat[1::2]]),
                arr(ctypes.c_int, [lv.shape[0] for lv in levels]),
                arr(ctypes.c_int, [lv.shape[1] for lv in levels]),
                arr(ctypes.c_int, [lv.max_ray_cells for lv in levels]),
                arr(ctypes.c_float, _f32([lv.point_scale for lv in levels])),
                arr(ctypes.c_float, scales),
                arr(ctypes.c_float, [float(o[0]) for o in off]),
                arr(ctypes.c_float, [float(o[1]) for o in off]),
                pose.data_ptr(), sin_t.data_ptr(), cos_t.data_ptr(),
                points.data_ptr(), origo.data_ptr(), mask.data_ptr(), scans,
                points.shape[-2], int(per_robot), counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"raster_paint: kernel launch failed with "
                               f"CUDA error {rc}")
        raster_paint.launches += 1
    shapes = [((scans,) if per_robot else ()) + tuple(lv.shape)
              for lv in levels]
    sets = [(flat[2 * k].view(s), flat[2 * k + 1].view(s))
            for k, s in enumerate(shapes)]
    return RasterSets(sets, counts[:-1], counts[-1])


raster_paint.launches = 0   # kernel launches, one an update (core/graphs.py)
