"""Log-odds occupancy map update: closed-form Bresenham rasterization plus
a commutative scatter, replacing the serial per-beam loop of
map/OccGridMapBase.h:121-260.

Counterpart of ``hector_slam_tpu/core/mapping.py``, which derives why the
per-scan update is two boolean masks:
  new = old + logOddsFree * [cell in free-set and not in occ-set]
            + logOddsOcc  * [cell in occ-set and old < 50]
The free cell j of a beam sits at the closed-form Bresenham offset
``start + j*offset_a + ((abs_da//2 + j*abs_db)//abs_da)*offset_b``, so
every free cell is a dense [N, K] integer computation. A map update
paints every level's free and occupied sets with one ``paint_cell_sets``
call (one zero fill and one launch of the CUDA kernel
``csrc/paint_cells.cu`` on the card).

The rasterizer broadcasts over leading axes, so a fleet's R scans cost
one paint call per update, like one scan: each set goes into one [H*W]
grid (a shared map: painting every gated robot's cells into one grid IS
the OR over robots), or, for per-robot maps, into one [R*H*W] grid with
robot r's cells offset by r*H*W.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch

from ..config import SlamConfig
from ..ops.paint_cells import paint_cell_sets
from ..types import Scan
from .cell_models import apply_update, storage_channels
from .collectives import por
from .grid import world_to_map_pose
from .matcher import level_points


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
    sentinel = torch.full((), num_cells, dtype=torch.int32,
                          device=p.valid.device)
    return (_dense_free_flat(p, num_cells, max_ray_cells),
            torch.where(p.valid, p.end_offset, sentinel), num_cells,
            _truncated_count(p, max_ray_cells))


def _level_sets(grid_shape, per_robot, pose_world, scan_points, scan_origo,
                scan_mask, offset, scale, max_ray_cells):
    """One level's (free, occupied) index pair, the shape of the grids it
    paints ((H, W), or (R, H, W) ``per_robot``) and its truncated cells."""
    free, occ, _, truncated = cell_indices(
        grid_shape, pose_world, scan_points, scan_origo, scan_mask, offset,
        scale, max_ray_cells, per_robot)
    shape = ((pose_world.shape[0],) if per_robot else ()) + tuple(grid_shape)
    return (free, occ), shape, truncated


def _update_levels(storages, level_inputs, cell_model: str,
                   log_odds_free: float, log_odds_occupied: float,
                   beam_axis=None):
    """Each storage updated with its level's scan inputs (pose, points,
    origo, mask, offset, scale, max_ray_cells): every level's index sets
    first, then all of them painted in one call (and OR-combined over
    ``beam_axis``), then each level updated. A storage with a leading
    robot axis beyond the cell model's own is R maps. Returns (new
    storages, this rank's truncated cells per level)."""
    pairs, shapes, truncated = [], [], []
    for lo, inputs in zip(storages, level_inputs):
        pair, shape, trunc = _level_sets(
            tuple(lo.shape[-2:]), lo.dim() > 1 + storage_channels(cell_model),
            *inputs)
        pairs.append(pair)
        shapes.append(shape)
        truncated.append(trunc)
    new = tuple(
        apply_update(lo, free_set & ~occ_set, occ_set, cell_model,
                     log_odds_free, log_odds_occupied)
        for lo, (free_set, occ_set) in zip(
            storages, _paint_pairs(pairs, shapes, beam_axis)))
    return new, truncated


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
    cell_model: str = "log_odds",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update of one level. Returns (new storage, truncated cells
    i32[(R,)]).

    One scan (pose f32[3]) or R scans (poses f32[R, 3]). A storage with a
    leading robot axis beyond the cell model's own ([R, H, W], or
    [R, 2, H, W] for reflectance) is R maps, scan r updating map r; else
    the R scans update the one map together. A robot whose mask is all
    False leaves its cells as they were. Its two sets are one paint
    call."""
    [new], [truncated] = _update_levels(
        [log_odds], [(pose_world, scan_points, scan_origo, scan_mask, offset,
                      scale, max_ray_cells)],
        cell_model, log_odds_free, log_odds_occupied)
    return new, truncated


def update_pyramid(
    log_odds_pyramid: Sequence[torch.Tensor],
    pose_world: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
    gates: torch.Tensor | None = None,
    beam_axis=None,
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

    Either way the update is one paint call: every level's indices are
    computed first, then all 2 x levels sets are painted together, then
    each level is updated. So every level's index tensors are alive at
    once: for 64 per-robot ``BENCH_CONFIG`` pyramids about 340 MB (191 MB
    of them the level-0 free set), plus 176 MB of bool grids.

    ``beam_axis``: the process group whose ranks' cell sets are
    OR-combined before the update (hector_slam_tpu/core/mapping.py:
    323-328): the beam shards of the same scans, or the robot shards of a
    shared-map fleet (parallel/shared_map.py). The truncated counts stay
    this rank's: the caller sums them over the group (per robot for beam
    shards, the fleet's total for robot shards)."""
    mcfg = cfg.map
    mask = scan.mask if gates is None else scan.mask & gates[:, None]
    new, truncated = _update_levels(
        log_odds_pyramid,
        [(pose_world, level_points(scan.points, level),
          level_points(scan.origo, level), mask, mcfg.top_left_offset,
          mcfg.level_scale(level), cfg.level_max_ray_cells(level))
         for level in range(len(log_odds_pyramid))],
        cfg.update.cell_model, cfg.update.log_odds_free,
        cfg.update.log_odds_occupied, beam_axis)
    truncated_total = torch.zeros(pose_world.shape[:-1], dtype=torch.int32,
                                  device=scan.points.device)
    for t in truncated:
        truncated_total = truncated_total + t
    return new, truncated_total
