"""Occupancy-grid export and map tooling.

Counterpart of ``hector_slam_tpu/export/occupancy.py``:
  - ``to_occupancy_grid``: storage -> int8 {-1 unknown, 0 free, 100
    occupied} as HectorMappingRos::publishMap does
    (src/HectorMappingRos.cpp:451-468: isFree -> 0, isOccupied -> 100,
    else -1), classified by the cell model; ``to_occupancy_grid_tensor``
    is the same on the tensor's own device, with no host copy.
  - ``GridMeta``: the OccupancyGrid metadata (resolution + world origin of
    cell (0,0)), and the CoordinateTransformer math of
    hector_map_tools/HectorMapTools.h:41-116.
  - ``map_extends``: bounding box of known cells
    (HectorMapTools.h:241-290).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import MapConfig
from ..core.cell_models import is_free, is_occupied


@dataclasses.dataclass(frozen=True)
class GridMeta:
    """OccupancyGrid-style metadata: cell edge length and the world
    coordinates of the (0,0) cell (map.info.origin). For our maps the
    origin is world coords of map cell (0,0)
    (HectorMappingRos.cpp:553-556 uses getWorldCoords(0,0))."""

    resolution: float
    origin: Tuple[float, float]
    width: int
    height: int

    # CoordinateTransformer (HectorMapTools.h:85-96):
    def world_to_map(self, xy: np.ndarray) -> np.ndarray:
        return ((np.asarray(xy, np.float32)
                 - np.asarray(self.origin, np.float32))
                * np.float32(1.0 / self.resolution))

    def map_to_world(self, xy: np.ndarray) -> np.ndarray:
        return (np.asarray(self.origin, np.float32)
                + np.asarray(xy, np.float32) * np.float32(self.resolution))


def grid_meta(cfg: MapConfig, level: int = 0) -> GridMeta:
    """Origin = world coords of map cell (0,0) minus half a cell
    (HectorMappingRos::setServiceGetMapData, :546-552). Cell (0,0) maps
    to ``0 * inv_s - inv_s * (s * offset)`` in f32, the affine inversion
    of ``core/grid.map_to_world``."""
    sx, sy = cfg.level_size(level)
    res = cfg.level_resolution(level)
    s = np.float32(1.0) / np.float32(res)
    inv_s = s * (np.float32(1.0) / (s * s))
    origin = (np.float32(0.0) * inv_s
              - inv_s * (np.asarray(cfg.top_left_offset, np.float32) * s))
    half = np.float32(res) * np.float32(0.5)
    ox, oy = (float(np.float32(origin[0]) - half),
              float(np.float32(origin[1]) - half))
    return GridMeta(resolution=res, origin=(ox, oy), width=sx, height=sy)


def to_occupancy_grid(log_odds, cell_model: str = "log_odds") -> np.ndarray:
    """int8[H, W] with {-1, 0, 100} (row-major, index y*W+x like the
    reference's flat data array), from a level's storage (a tensor on any
    device, or a numpy array). Classification follows the cell model's
    isOccupied/isFree thresholds."""
    return to_occupancy_grid_tensor(torch.as_tensor(log_odds),
                                    cell_model).cpu().numpy()


def to_occupancy_grid_tensor(log_odds: torch.Tensor,
                             cell_model: str = "log_odds") -> torch.Tensor:
    """``to_occupancy_grid`` on the storage's own device: an int8 tensor,
    no host copy (the JAX package's ``to_occupancy_grid_jax``)."""
    occ = is_occupied(log_odds, cell_model)
    free = is_free(log_odds, cell_model)
    return torch.where(occ, 100, torch.where(free, 0, -1)).to(torch.int8)


# the JAX package's name for the device-side grid
to_occupancy_grid_jax = to_occupancy_grid_tensor


def map_extends(occ_grid: np.ndarray
                ) -> Optional[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Bounding box of known (!= -1) cells: ((xmin, ymin),
    (xmax+1, ymax+1)), or None if the map is empty
    (HectorMapTools.h:241-290)."""
    known = np.asarray(occ_grid) != -1
    ys, xs = np.nonzero(known)
    if len(xs) == 0:
        return None
    return ((int(xs.min()), int(ys.min())),
            (int(xs.max()) + 1, int(ys.max()) + 1))
