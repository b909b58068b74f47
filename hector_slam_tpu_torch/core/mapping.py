"""Log-odds occupancy map update: closed-form Bresenham rasterization plus
a commutative scatter, replacing the serial per-beam loop of
map/OccGridMapBase.h:121-260.

Counterpart of ``hector_slam_tpu/core/mapping.py``, which derives why the
per-scan update is two boolean masks:
  new = old + logOddsFree * [cell in free-set and not in occ-set]
            + logOddsOcc  * [cell in occ-set and old < 50]
The free cell j of a beam sits at the closed-form Bresenham offset
``start + j*offset_a + ((abs_da//2 + j*abs_db)//abs_da)*offset_b``, so
every free cell is a dense [N, K] integer computation. On the card a
map update rasterizes and paints every level's free and occupied sets
in one launch of the CUDA kernel ``csrc/raster_paint.cu``
(``ops/raster_paint.py``, after one zero fill), which stores each cell
straight into the grids; on the CPU the index sets are built in torch
ops and painted with one ``paint_cell_sets`` call. The steps apply the
painted sets with ``integrate_sets``: the map tail kernel pair
(ops/map_tail.py) writes the levels and packs the matcher's quads anew,
only for the maps whose gate fired; ``update_pyramid`` applies them
with ``apply_update`` into new tensors, as the JAX package's does.

The rasterizer broadcasts over leading axes, so a fleet's R scans cost
one paint per update, like one scan: each set goes into one [H*W]
grid (a shared map: painting every gated robot's cells into one grid IS
the OR over robots), or, for per-robot maps, into one [R*H*W] grid with
robot r's cells offset by r*H*W.

One scan's free set has a second layout, the segment-compacted one
(``raster_backend="seg"``, the JAX package's ``rasterize_scan_seg``):
the valid 64-cell beam segments are compacted first, so the set holds
about as many slots as the scan has free cells instead of one slot per
possible cell of every beam. A level whose segments overflow the budget
paints its dense set instead, chosen on the device. Both layouts give
the same cells, so on the card, where no index set is built, the kernel
paints them whichever layout ``pick_raster_backend`` names.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..config import SlamConfig
from ..ops.map_tail import map_tail
from ..ops.paint_cells import paint_cell_sets
from ..ops.raster_paint import RasterLevel, level_scaled, raster_paint
from ..types import Scan
from .cell_models import apply_update, storage_channels
from .collectives import por
from .grid import world_to_map_pose
from .interp import quad_pack_storage


def _sign_ref(x: torch.Tensor) -> torch.Tensor:
    """util/UtilFunctions.h:56 — sign(0) == -1."""
    one = torch.ones((), dtype=torch.int32, device=x.device)
    return torch.where(x > 0, one, -one)


class _RayParams(NamedTuple):
    """Flat-offset Bresenham parameters of one scan's beams ([N]) or of R
    scans' beams ([R, N])."""

    valid: torch.Tensor         # bool[..., N]
    abs_da: torch.Tensor        # i32[..., N] dominant-axis span
    abs_db: torch.Tensor        # i32[..., N] minor-axis span
    offset_a: torch.Tensor      # i32[..., N] flat step per dominant cell
    offset_b: torch.Tensor      # i32[..., N] flat step on minor advance
    start_offset: torch.Tensor  # i32[..., 1] the scan's sensor-origin cell
    end_offset: torch.Tensor    # i32[..., N] each beam's end cell


def _bresenham_params(grid_shape, pose_world, scan_points, scan_origo,
                      scan_mask, offset, scale, base=None) -> _RayParams:
    """Beam start/end cells, validity and Bresenham parameters with the
    reference's rounding and validity rules (OccGridMapBase.h:134-158,
    176,186). Poses f32[..., 3], points f32[..., N, 2], origo f32[..., 2],
    mask bool[..., N]. ``base`` i32[..., 1], when given, is added to every
    flat cell index (robot r's grid starts at r*H*W)."""
    h, w = grid_shape
    pose_map = world_to_map_pose(pose_world, offset, scale)
    s = torch.sin(pose_map[..., 2:3])
    c = torch.cos(pose_map[..., 2:3])
    tx = pose_map[..., 0:1]
    ty = pose_map[..., 1:2]

    # beam start: transform origo in Eigen's m00*px + (m01*py + t) order,
    # round via +0.5 then int cast (OccGridMapBase.h:134-137); the +0.5
    # rounding can flip a cell on a 1-ulp difference, so the expression
    # order is the JAX package's (hector_slam_tpu/core/mapping.py:68-77)
    ox = c * scan_origo[..., 0:1] + (-s * scan_origo[..., 1:2] + tx)
    oy = s * scan_origo[..., 0:1] + (c * scan_origo[..., 1:2] + ty)
    bx = (ox + 0.5).to(torch.int32)
    by = (oy + 0.5).to(torch.int32)

    # beam endpoints, same rounding (OccGridMapBase.h:148-155)
    px = scan_points[..., 0]
    py = scan_points[..., 1]
    ex = (c * px + (-s * py + tx) + 0.5).to(torch.int32)
    ey = (s * px + (c * py + ty) + 0.5).to(torch.int32)

    # skip if start==end cell (OccGridMapBase.h:158), or start/end outside
    # the map (OccGridMapBase.h:176,186)
    begin_in = (bx >= 0) & (bx < w) & (by >= 0) & (by < h)
    end_in = (ex >= 0) & (ex < w) & (ey >= 0) & (ey < h)
    differs = (ex != bx) | (ey != by)
    valid = scan_mask & differs & begin_in & end_in

    dx = ex - bx
    dy = ey - by
    abs_dx = dx.abs()
    abs_dy = dy.abs()
    x_dom = abs_dx >= abs_dy
    offset_dx = _sign_ref(dx)
    offset_dy = _sign_ref(dy) * w
    start_offset = by * w + bx
    end_offset = ey * w + ex
    if base is not None:
        start_offset = start_offset + base
        end_offset = end_offset + base
    return _RayParams(
        valid=valid,
        abs_da=torch.where(x_dom, abs_dx, abs_dy),
        abs_db=torch.where(x_dom, abs_dy, abs_dx),
        offset_a=torch.where(x_dom, offset_dx, offset_dy),
        offset_b=torch.where(x_dom, offset_dy, offset_dx),
        start_offset=start_offset,
        end_offset=end_offset,
    )


def _paint_pairs(pairs, shapes, beam_axis=None):
    """Commutative scatter-OR of every (free, occupied) index pair into
    bool grids of ``shapes[k]``, (H, W) or, for per-robot indices offset
    by r*H*W, (R, H, W): one ``paint_cell_sets`` call for all pairs; the
    sentinel index (== num cells) drops. ``beam_axis``: the grids are then
    OR-combined over the process group's ranks (one all-reduce)."""
    grids = paint_cell_sets([f for pair in pairs for f in pair],
                            [math.prod(s) for s in shapes for _ in (0, 1)])
    grids = por(grids, beam_axis)
    return [(grids[2 * k].reshape(s), grids[2 * k + 1].reshape(s))
            for k, s in enumerate(shapes)]


def _dense_free_flat(p: _RayParams, num_cells: int,
                     max_ray_cells: int) -> torch.Tensor:
    """Free cells as the dense [..., N, K] slot tensor (one slot per
    possible cell of every beam; masked slots hold the sentinel)."""
    abs_da_safe = torch.clamp(p.abs_da, min=1)   # valid beams have >= 1
    steps = torch.arange(max_ray_cells, dtype=torch.int32,
                         device=p.abs_da.device)                  # [K]
    err0 = (p.abs_da // 2)[..., None]
    minor = (err0 + steps * p.abs_db[..., None]) // abs_da_safe[..., None]
    free_flat = (p.start_offset[..., None] + steps * p.offset_a[..., None]
                 + minor * p.offset_b[..., None])
    free_mask = p.valid[..., None] & (steps < p.abs_da[..., None])
    sentinel = torch.full((), num_cells, dtype=torch.int32,
                          device=free_flat.device)
    return torch.where(free_mask, free_flat, sentinel)


def _truncated_count(p: _RayParams, max_ray_cells: int) -> torch.Tensor:
    # cells dropped by the static cap (the reference marks them all)
    over = torch.clamp(p.abs_da - max_ray_cells, min=0)
    return torch.where(p.valid, over, torch.zeros_like(over)).sum(-1).to(
        torch.int32)


def _occupied_flat(p: _RayParams, num_cells: int) -> torch.Tensor:
    sentinel = torch.full((), num_cells, dtype=torch.int32,
                          device=p.valid.device)
    return torch.where(p.valid, p.end_offset, sentinel)


def cell_indices(
    grid_shape: Tuple[int, int],
    pose_world: torch.Tensor,    # f32[3] or f32[R, 3]
    scan_points: torch.Tensor,   # f32[(R,) N, 2] this level's scaled points
    scan_origo: torch.Tensor,    # f32[(R,) 2]
    scan_mask: torch.Tensor,     # bool[(R,) N]
    offset,
    scale,
    max_ray_cells: int,
    per_robot: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
    """The flat cell indices one update paints, for one scan or R scans:
    (free i32[(R,) N, K], occupied i32[(R,) N], num_cells, truncated
    i32[(R,)]). Masked slots and invalid beams hold the sentinel
    ``num_cells``.

    By default every scan indexes one [H*W] grid (one scan, or a shared
    map). ``per_robot``: scan r indexes grid r of one [R*H*W] grid, its
    cells offset by r*H*W through the beams' start and end offsets."""
    num_cells = grid_shape[0] * grid_shape[1]
    base = None
    if per_robot:
        r = pose_world.shape[0]
        base = (torch.arange(r, dtype=torch.int32, device=pose_world.device)
                * num_cells)[:, None]
        num_cells *= r
    p = _bresenham_params(grid_shape, pose_world, scan_points, scan_origo,
                          scan_mask, offset, scale, base)
    return (_dense_free_flat(p, num_cells, max_ray_cells),
            _occupied_flat(p, num_cells), num_cells,
            _truncated_count(p, max_ray_cells))


_SEG = 64   # cells per compacted beam segment


def seg_budget(n_beams: int, max_ray_cells: int,
               budget_segments: int = 0) -> Tuple[int, int]:
    """(segments per beam, segment budget) of a scan of ``n_beams``: the
    JAX package's rule (hector_slam_tpu/core/mapping.py:235-237), a sixth
    of the dense slots floored at 1.25 x n_beams, unless
    ``budget_segments`` > 0 sets the budget. Python ints of the static
    shapes."""
    k_seg = -(-max_ray_cells // _SEG)
    if budget_segments <= 0:
        budget_segments = max(8, n_beams + (n_beams >> 2),
                              (n_beams * k_seg) // 6)
    return k_seg, budget_segments


def seg_cell_indices(
    grid_shape: Tuple[int, int],
    pose_world: torch.Tensor,    # f32[3]
    scan_points: torch.Tensor,   # f32[N, 2] this level's scaled points
    scan_origo: torch.Tensor,    # f32[2]
    scan_mask: torch.Tensor,     # bool[N]
    offset,
    scale,
    max_ray_cells: int,
    budget_segments: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor, torch.Tensor,
           int]:
    """``cell_indices`` of one scan with the free set compacted by
    segments: (free i32[budget, 64], occupied i32[N], num_cells,
    truncated i32[], segment total i32[], budget).

    Each valid beam paints ``min(abs_da, max_ray_cells)`` cells, cut into
    64-cell segments; the segments are numbered in beam order by a
    cumsum and the first ``budget`` of them found by a searchsorted, so
    slot (s, j) holds cell j of segment s (the JAX package's
    ``rasterize_scan_seg``, hector_slam_tpu/core/mapping.py:239-268).
    Slots past the total or a beam's length hold the sentinel
    ``num_cells``. When the total exceeds the budget the set misses
    segments: the dense set (``cell_indices``) is painted instead, as
    ``_seg_pairs`` arranges."""
    if pose_world.dim() != 1:
        raise ValueError("the segment-compacted free set takes one scan "
                         f"(pose f32[3]), got poses {tuple(pose_world.shape)}")
    num_cells = grid_shape[0] * grid_shape[1]
    n_beams = scan_points.shape[0]
    k_seg, budget = seg_budget(n_beams, max_ray_cells, budget_segments)
    p = _bresenham_params(grid_shape, pose_world, scan_points, scan_origo,
                          scan_mask, offset, scale)
    dev = p.abs_da.device
    abs_da_safe = torch.clamp(p.abs_da, min=1)
    err0 = p.abs_da // 2
    length = torch.clamp(p.abs_da, max=max_ray_cells)  # painted cells/beam

    # valid segments per beam: ceil(length/SEG); compact (beam, seg) ids
    n_seg = torch.where(p.valid, (length + (_SEG - 1)) // _SEG,
                        torch.zeros_like(length))                  # [N]
    seg_valid = (torch.arange(k_seg, dtype=torch.int32, device=dev)
                 < n_seg[:, None])                                 # [N, Ks]
    pos = torch.cumsum(seg_valid.reshape(-1).to(torch.int32), 0,
                       dtype=torch.int32)
    total = pos[-1]
    flat_ids = torch.clamp(torch.searchsorted(pos, torch.arange(
        1, budget + 1, dtype=torch.int32, device=dev)),
        max=n_beams * k_seg - 1)
    slot_ok = torch.arange(budget, device=dev) < total
    b_i = flat_ids // k_seg
    j = ((flat_ids % k_seg).to(torch.int32)[:, None] * _SEG
         + torch.arange(_SEG, dtype=torch.int32, device=dev))      # [B, SEG]
    minor = (err0[b_i][:, None] + j * p.abs_db[b_i][:, None]) \
        // abs_da_safe[b_i][:, None]
    flat = (p.start_offset + j * p.offset_a[b_i][:, None]
            + minor * p.offset_b[b_i][:, None])
    keep = slot_ok[:, None] & (j < length[b_i][:, None])
    free = torch.where(keep, flat, torch.full((), num_cells,
                                              dtype=torch.int32, device=dev))
    return (free, _occupied_flat(p, num_cells), num_cells,
            _truncated_count(p, max_ray_cells), total, budget)


def _seg_pairs(grid_shapes, level_inputs, budget_segments=0):
    """Each level's segment-compacted (free, occupied) index pair and
    truncated cells, for one scan. A level whose segment total exceeds
    its budget takes its dense free set instead (the JAX package's
    ``lax.cond``, hector_slam_tpu/core/mapping.py:270-273), chosen on the
    device with no host read: the level's free set is its compacted set
    followed by its dense set, and the one not chosen holds only the
    sentinel, so the cells are the same."""
    built = [seg_cell_indices(shape, *inputs, budget_segments=budget_segments)
             for shape, inputs in zip(grid_shapes, level_inputs)]
    pairs = []
    for shape, inputs, (free, occ, num_cells, _, total, budget) in zip(
            grid_shapes, level_inputs, built):
        fits = total <= budget
        sentinel = torch.full((), num_cells, dtype=torch.int32,
                              device=free.device)
        dense = cell_indices(shape, *inputs)[0]
        pairs.append((torch.cat([
            torch.where(fits, free, sentinel).reshape(-1),
            torch.where(fits, sentinel, dense).reshape(-1)]), occ))
    return pairs, [b[3] for b in built]


def pick_raster_backend(raster_backend, device: torch.device,
                        beam_axis=None, one_scan: bool = True) -> str:
    """The free-set layout of an update: "seg" (segment-compacted) or
    "xla" (the JAX package's name for the dense layout). ``None`` is the
    JAX package's auto rule (hector_slam_tpu/core/mapping.py:312-314)
    with the card as the accelerator: "seg" for one scan on a CUDA
    device with no ``beam_axis``, "xla" otherwise. An explicit "seg"
    takes one scan only (``one_scan``: no robot axis and no gates)."""
    if raster_backend is None:
        return ("seg" if device.type == "cuda" and beam_axis is None
                and one_scan else "xla")
    if raster_backend not in ("seg", "xla"):
        raise ValueError(f"raster_backend must be 'seg', 'xla' or None, got "
                         f"{raster_backend!r}")
    if raster_backend == "seg" and not one_scan:
        raise ValueError("raster_backend='seg' takes one scan: a fleet's "
                         "update paints the dense free sets")
    return raster_backend


def _level_sets(grid_shape, per_robot, pose_world, scan_points, scan_origo,
                scan_mask, offset, scale, max_ray_cells):
    """One level's (free, occupied) index pair, the shape of the grids it
    paints ((H, W), or (R, H, W) ``per_robot``) and its truncated cells."""
    free, occ, _, truncated = cell_indices(
        grid_shape, pose_world, scan_points, scan_origo, scan_mask, offset,
        scale, max_ray_cells, per_robot)
    shape = ((pose_world.shape[0],) if per_robot else ()) + tuple(grid_shape)
    return (free, occ), shape, truncated


def _paint_levels(storages, pose_world, points, origo, mask,
                  levels: Sequence[RasterLevel], cell_model: str,
                  beam_axis=None, raster_backend=None):
    """Each storage's cell sets from the scans (pose, points and origo in
    the world frame, mask) and its level's geometry (``levels``, the
    storages' grid shapes among it), painted in one go and OR-combined
    over ``beam_axis``. A storage with a leading robot axis beyond the
    cell model's own is R maps. On the card one
    ``raster_paint`` launch paints every level; on the CPU every level's
    index sets are built first (their layout by ``pick_raster_backend``),
    then all of them painted in one call. Returns (each level's painted
    (free, occupied) bool grids, this rank's truncated cells summed over
    levels, i32[(R,)])."""
    dev = storages[0].device
    per_robot = storages[0].dim() > 1 + storage_channels(cell_model)
    one_scan = pose_world.dim() == 1 and not per_robot
    backend = pick_raster_backend(raster_backend, dev, beam_axis, one_scan)
    if dev.type == "cuda":
        sets, _, truncated = raster_paint(levels, pose_world, points, origo,
                                          mask, per_robot)
        grids = por([g for pair in sets for g in pair], beam_axis)
        return list(zip(grids[0::2], grids[1::2])), truncated
    level_inputs = [
        (pose_world, level_scaled(points, lv), level_scaled(origo, lv),
         mask, lv.offset, lv.scale, lv.max_ray_cells) for lv in levels]
    if backend == "seg":
        shapes = [lv.shape for lv in levels]
        pairs, counts = _seg_pairs(shapes, level_inputs)
    else:
        pairs, shapes, counts = zip(*(
            _level_sets(lv.shape, per_robot, *inputs)
            for lv, inputs in zip(levels, level_inputs)))
    truncated = torch.zeros(pose_world.shape[:-1], dtype=torch.int32,
                            device=dev)
    for t in counts:
        truncated = truncated + t
    return _paint_pairs(pairs, shapes, beam_axis), truncated


def rasterize_scan(
    grid_shape: Tuple[int, int],
    pose_world: torch.Tensor,
    scan_points: torch.Tensor,
    scan_origo: torch.Tensor,
    scan_mask: torch.Tensor,
    offset,
    scale,
    max_ray_cells: int,
    per_robot: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-scan free/occupied boolean grids for one level (shapes as in
    ``cell_indices``).

    Returns (free_set, occ_set, truncated_cells): bool[H, W] sets (the OR
    over scans when R scans are given), or bool[R, H, W] with
    ``per_robot``. ``truncated_cells`` counts free cells dropped because a
    beam's dominant-axis span exceeded ``max_ray_cells`` (nonzero means a
    divergence from the reference)."""
    pair, shape, truncated = _level_sets(
        grid_shape, per_robot, pose_world, scan_points, scan_origo,
        scan_mask, offset, scale, max_ray_cells)
    [(free_set, occ_set)] = _paint_pairs([pair], [shape])
    return free_set, occ_set, truncated


def rasterize_scan_seg(
    grid_shape: Tuple[int, int],
    pose_world: torch.Tensor,
    scan_points: torch.Tensor,
    scan_origo: torch.Tensor,
    scan_mask: torch.Tensor,
    offset,
    scale,
    max_ray_cells: int,
    budget_segments: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``rasterize_scan`` of one scan through the segment-compacted free
    set (``seg_cell_indices``; the budget as in ``seg_budget``): the same
    (free_set bool[H, W], occ_set bool[H, W], truncated i32[]). Past the
    budget the free set is the dense one, chosen on the device, so the
    cells are always ``rasterize_scan``'s."""
    [pair], [truncated] = _seg_pairs(
        [grid_shape], [(pose_world, scan_points, scan_origo, scan_mask,
                        offset, scale, max_ray_cells)], budget_segments)
    [(free_set, occ_set)] = _paint_pairs([pair], [tuple(grid_shape)])
    return free_set, occ_set, truncated


def update_level(
    log_odds: torch.Tensor,
    pose_world: torch.Tensor,
    scan_points: torch.Tensor,
    scan_origo: torch.Tensor,
    scan_mask: torch.Tensor,
    offset,
    scale,
    max_ray_cells: int,
    log_odds_free: float,
    log_odds_occupied: float,
    beam_axis=None,
    cell_model: str = "log_odds",
    raster_backend: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update of one level. Returns (new storage, truncated cells
    i32[(R,)]).

    One scan (pose f32[3]) or R scans (poses f32[R, 3]). A storage with a
    leading robot axis beyond the cell model's own ([R, H, W], or
    [R, 2, H, W] for reflectance) is R maps, scan r updating map r; else
    the R scans update the one map together. A robot whose mask is all
    False leaves its cells as they were. Its two sets are one paint.

    ``beam_axis`` and the truncated count as in ``update_pyramid``;
    ``raster_backend`` as in ``pick_raster_backend`` (the JAX package's
    ``update_level`` parameters, in its order)."""
    [(free_set, occ_set)], truncated = _paint_levels(
        [log_odds], pose_world, scan_points, scan_origo, scan_mask,
        [RasterLevel(tuple(log_odds.shape[-2:]), 1.0, offset, scale,
                     max_ray_cells)],
        cell_model, beam_axis, raster_backend)
    return apply_update(log_odds, free_set & ~occ_set, occ_set, cell_model,
                        log_odds_free, log_odds_occupied), truncated


def update_pyramid(
    log_odds_pyramid: Sequence[torch.Tensor],
    pose_world: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    beam_axis=None,
    raster_backend: str | None = None,
    *,
    gates: torch.Tensor | None = None,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """MapRepMultiMap::updateByScan (MapRepMultiMap.h:134-147): every level
    updated independently with its 2^-level-scaled scan. Returns (new
    pyramid, truncated cells i32[(R,)] summed over levels).

    A fleet passes R poses and scans (points [R, N, 2]) and ``gates``
    bool[R], the robots whose scans integrate; the others' beams are
    masked, so they add no cell and count no truncation. Per-robot
    pyramids (a leading R axis on every level) take scan r into map r; a
    shared pyramid takes the union of the gated robots' cell sets in one
    update (occupied wins across robots as across beams,
    hector_slam_tpu/parallel/shared_map.py:6-15).

    Either way the update is one paint: on the card one ``raster_paint``
    launch stores every level's cells into the bool grids (for 64
    per-robot ``BENCH_CONFIG`` pyramids 176 MB), with no index tensor; on
    the CPU every level's indices are computed first, then all 2 x levels
    sets are painted in one call, then each level is updated.

    ``beam_axis``: the process group whose ranks' cell sets are
    OR-combined before the update (hector_slam_tpu/core/mapping.py:
    323-328): the beam shards of the same scans, or the robot shards of a
    shared-map fleet (parallel/shared_map.py). The truncated counts stay
    this rank's: the caller sums them over the group (per robot for beam
    shards, the fleet's total for robot shards).

    ``raster_backend``: the free sets' layout, "seg" (compacted by
    segments, one scan only) or "xla" (dense); None picks "seg" for one
    scan on the card with no ``beam_axis`` and no ``gates``, else "xla"
    (``pick_raster_backend``). Both paint the same cells: "seg" paints a
    level's compacted set and its dense set, and the device masks the
    dense one, or past the budget the compacted one, so the update reads
    nothing on the host. On the card the kernel builds no set of either
    layout and paints those same cells."""
    sets, truncated = paint_pyramid(log_odds_pyramid, pose_world, scan, cfg,
                                    beam_axis, raster_backend, gates=gates)
    upd = cfg.update
    return tuple(
        apply_update(lo, free_set & ~occ_set, occ_set, upd.cell_model,
                     upd.log_odds_free, upd.log_odds_occupied)
        for lo, (free_set, occ_set) in zip(log_odds_pyramid, sets)), \
        truncated


def paint_pyramid(
    log_odds_pyramid: Sequence[torch.Tensor],
    pose_world: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    beam_axis=None,
    raster_backend: str | None = None,
    *,
    gates: torch.Tensor | None = None,
) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]:
    """``update_pyramid``'s cell sets, painted and not yet applied: (each
    level's (free, occupied) bool grids, shaped as its storage without
    the channel axis, truncated cells i32[(R,)] summed over levels).
    Arguments as in ``update_pyramid``; ``integrate_sets`` applies them."""
    mcfg = cfg.map
    mask = scan.mask if gates is None else scan.mask & gates[:, None]
    return _paint_levels(
        log_odds_pyramid, pose_world, scan.points, scan.origo, mask,
        [RasterLevel(tuple(lo.shape[-2:]), 1.0 / (2.0 ** level),
                     mcfg.top_left_offset, mcfg.level_scale(level),
                     cfg.level_max_ray_cells(level))
         for level, lo in enumerate(log_odds_pyramid)],
        cfg.update.cell_model, beam_axis, raster_backend)


def integrate_sets(
    log_odds_pyramid: Sequence[torch.Tensor],
    quads: Sequence[torch.Tensor],
    sets: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    gate: torch.Tensor,
    cfg: SlamConfig,
    in_place: bool = False,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """One update's painted cell sets (``paint_pyramid``) applied to the
    maps whose ``gate`` fired (bool: one for every map, or one a robot),
    and those maps' quads packed anew, by ``ops/map_tail.map_tail``:
    the other maps keep their levels and quads bit for bit. Returns (new
    pyramid, new quads). ``in_place``: written into ``log_odds_pyramid``
    and ``quads`` themselves and returned as they are (a donating step's
    own maps); otherwise into copies, and the inputs are left as they
    were. A pyramid given without quads (``quads`` empty) has them packed
    first."""
    if not quads:
        quads = tuple(quad_pack_storage(lo, cfg.update.cell_model)
                      for lo in log_odds_pyramid)
    elif not in_place:
        quads = tuple(q.clone() for q in quads)
    if not in_place:
        log_odds_pyramid = tuple(lo.clone() for lo in log_odds_pyramid)
    map_tail(log_odds_pyramid, quads, sets, gate, cfg.update.cell_model,
             cfg.update.log_odds_free, cfg.update.log_odds_occupied)
    return tuple(log_odds_pyramid), tuple(quads)
