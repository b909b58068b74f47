"""Log-odds occupancy map update: closed-form Bresenham rasterization plus
a commutative scatter, replacing the serial per-beam loop of
map/OccGridMapBase.h:121-260.

Counterpart of the dense path of ``hector_slam_tpu/core/mapping.py``,
which derives why the per-scan update is two boolean masks:
  new = old + logOddsFree * [cell in free-set and not in occ-set]
            + logOddsOcc  * [cell in occ-set and old < 50]
The free cell j of a beam sits at the closed-form Bresenham offset
``start + j*offset_a + ((abs_da//2 + j*abs_db)//abs_da)*offset_b``, so
every free cell is a dense [N, K] integer computation.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..config import SlamConfig
from ..types import Scan
from .cell_models import apply_update
from .grid import world_to_map_pose
from .matcher import level_points


def _sign_ref(x: torch.Tensor) -> torch.Tensor:
    """util/UtilFunctions.h:56 — sign(0) == -1."""
    one = torch.ones((), dtype=torch.int32, device=x.device)
    return torch.where(x > 0, one, -one)


class _RayParams(NamedTuple):
    """Flat-offset Bresenham parameters for one scan's beams."""

    ex: torch.Tensor            # i32[N] end cell x
    ey: torch.Tensor            # i32[N] end cell y
    valid: torch.Tensor         # bool[N]
    abs_da: torch.Tensor        # i32[N] dominant-axis span
    abs_db: torch.Tensor        # i32[N] minor-axis span
    offset_a: torch.Tensor      # i32[N] flat step per dominant cell
    offset_b: torch.Tensor      # i32[N] flat step on minor advance
    start_offset: torch.Tensor  # i32[] shared sensor-origin cell


def _bresenham_params(grid_shape, pose_world, scan_points, scan_origo,
                      scan_mask, offset, scale) -> _RayParams:
    """Beam start/end cells, validity and Bresenham parameters with the
    reference's rounding and validity rules (OccGridMapBase.h:134-158,
    176,186)."""
    h, w = grid_shape
    pose_map = world_to_map_pose(pose_world, offset, scale)
    s = torch.sin(pose_map[2])
    c = torch.cos(pose_map[2])

    # beam start: transform origo in Eigen's m00*px + (m01*py + t) order,
    # round via +0.5 then int cast (OccGridMapBase.h:134-137); the +0.5
    # rounding can flip a cell on a 1-ulp difference, so the expression
    # order is the JAX package's (hector_slam_tpu/core/mapping.py:68-77)
    ox = c * scan_origo[0] + (-s * scan_origo[1] + pose_map[0])
    oy = s * scan_origo[0] + (c * scan_origo[1] + pose_map[1])
    bx = (ox + 0.5).to(torch.int32)
    by = (oy + 0.5).to(torch.int32)

    # beam endpoints, same rounding (OccGridMapBase.h:148-155)
    ex = (c * scan_points[:, 0] + (-s * scan_points[:, 1] + pose_map[0])
          + 0.5).to(torch.int32)
    ey = (s * scan_points[:, 0] + (c * scan_points[:, 1] + pose_map[1])
          + 0.5).to(torch.int32)

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
    return _RayParams(
        ex=ex, ey=ey, valid=valid,
        abs_da=torch.where(x_dom, abs_dx, abs_dy),
        abs_db=torch.where(x_dom, abs_dy, abs_dx),
        offset_a=torch.where(x_dom, offset_dx, offset_dy),
        offset_b=torch.where(x_dom, offset_dy, offset_dx),
        start_offset=by * w + bx,
    )


def _scatter_true(flat: torch.Tensor, grid_shape) -> torch.Tensor:
    """Commutative scatter-OR. The sentinel index (== num cells) lands in
    one extra slot that is sliced off (index_put_ has no drop mode)."""
    h, w = grid_shape
    out = torch.zeros(h * w + 1, dtype=torch.bool, device=flat.device)
    out[flat.reshape(-1).to(torch.int64)] = True
    return out[:-1].reshape(h, w)


def _dense_free_set(p: _RayParams, grid_shape, max_ray_cells: int):
    """Free set via the dense [N, K] slot scatter (one slot per possible
    cell of every beam; masked slots target the sentinel)."""
    num_cells = grid_shape[0] * grid_shape[1]
    abs_da_safe = torch.clamp(p.abs_da, min=1)   # valid beams have >= 1
    steps = torch.arange(max_ray_cells, dtype=torch.int32,
                         device=p.abs_da.device)[None, :]        # [1, K]
    err0 = (p.abs_da // 2)[:, None]
    minor = (err0 + steps * p.abs_db[:, None]) // abs_da_safe[:, None]
    free_flat = (p.start_offset + steps * p.offset_a[:, None]
                 + minor * p.offset_b[:, None])
    free_mask = p.valid[:, None] & (steps < p.abs_da[:, None])
    sentinel = torch.full((), num_cells, dtype=torch.int32,
                          device=free_flat.device)
    return _scatter_true(torch.where(free_mask, free_flat, sentinel),
                         grid_shape)


def _occ_set(p: _RayParams, grid_shape) -> torch.Tensor:
    num_cells = grid_shape[0] * grid_shape[1]
    sentinel = torch.full((), num_cells, dtype=torch.int32,
                          device=p.ex.device)
    occ_flat = torch.where(p.valid, p.ey * grid_shape[1] + p.ex, sentinel)
    return _scatter_true(occ_flat, grid_shape)


def _truncated_count(p: _RayParams, max_ray_cells: int) -> torch.Tensor:
    # cells dropped by the static cap (the reference marks them all)
    over = torch.clamp(p.abs_da - max_ray_cells, min=0)
    return torch.where(p.valid, over, torch.zeros_like(over)).sum().to(
        torch.int32)


def rasterize_scan(
    grid_shape: Tuple[int, int],
    pose_world: torch.Tensor,
    scan_points: torch.Tensor,   # f32[N,2] this level's scaled points
    scan_origo: torch.Tensor,    # f32[2]
    scan_mask: torch.Tensor,     # bool[N]
    offset,
    scale,
    max_ray_cells: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-scan free/occupied boolean grids for one level.

    Returns (free_set bool[H,W], occ_set bool[H,W], truncated_cells i32[]):
    ``truncated_cells`` counts free cells dropped because a beam's
    dominant-axis span exceeded ``max_ray_cells`` (nonzero means a
    divergence from the reference)."""
    p = _bresenham_params(grid_shape, pose_world, scan_points,
                          scan_origo, scan_mask, offset, scale)
    return (_dense_free_set(p, grid_shape, max_ray_cells),
            _occ_set(p, grid_shape), _truncated_count(p, max_ray_cells))


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
    """One scan's update of one level. Returns (new storage, truncated
    cells i32[])."""
    free_set, occ_set, truncated = rasterize_scan(
        tuple(log_odds.shape[-2:]), pose_world, scan_points, scan_origo,
        scan_mask, offset, scale, max_ray_cells)
    new = apply_update(log_odds, free_set & ~occ_set, occ_set, cell_model,
                       log_odds_free, log_odds_occupied)
    return new, truncated


def update_pyramid(
    log_odds_pyramid: Sequence[torch.Tensor],
    pose_world: torch.Tensor,
    scan: Scan,
    cfg: SlamConfig,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """MapRepMultiMap::updateByScan (MapRepMultiMap.h:134-147): every level
    updated independently with its 2^-level-scaled scan. Returns (new
    pyramid, truncated cells i32[] summed over levels)."""
    mcfg = cfg.map
    out = []
    truncated_total = torch.zeros((), dtype=torch.int32,
                                  device=scan.points.device)
    for level, lo in enumerate(log_odds_pyramid):
        new_lo, truncated = update_level(
            lo, pose_world, level_points(scan.points, level),
            level_points(scan.origo, level), scan.mask,
            mcfg.top_left_offset, mcfg.level_scale(level),
            cfg.level_max_ray_cells(level),
            cfg.update.log_odds_free, cfg.update.log_odds_occupied,
            cfg.update.cell_model)
        out.append(new_lo)
        truncated_total = truncated_total + truncated
    return tuple(out), truncated_total
