"""Static configuration for the PyTorch/CUDA hector-slam engine.

A copy of ``hector_slam_tpu/config.py`` (the port imports nothing of the
JAX package): the same frozen dataclasses and presets, field for field,
so both packages read one configuration identically. Replaces the
reference's ROS parameter server + launch-file injection (reference:
hector_mapping/src/HectorMappingRos.cpp:59-108,
hector_mapping/launch/mapping_default.launch).

Defaults reproduce the hector_mapping node defaults:
  - resolution 0.025 m, 1024x1024 cells, 3 pyramid levels
    (HectorMappingRos.cpp:66-70)
  - update factors free=0.4, occupied=0.9 (HectorMappingRos.cpp:72-73)
  - map-update gate 0.4 m / 0.9 rad (HectorMappingRos.cpp:75-76)
  - map starts centered: start_coords (0.5, 0.5) (HectorMappingRos.cpp:113)
  - GN iterations: 5 at the finest level, 3 at coarser levels, each +1
    (MapRepMultiMap.h:125-128, ScanMatcher.h:74,94)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Geometry of the multi-resolution occupancy-grid pyramid.

    Level i has cell length ``resolution * 2**i`` and dimensions
    ``size // 2**i`` (MapRepMultiMap.h:48-72: ``resolution /= 2;
    mapResolution *= 2.0f`` per level). All levels share one world-frame
    top-left offset ``total_map_size * start_coords``.
    """

    resolution: float = 0.025          # finest cell length [m]
    size_x: int = 1024                 # finest grid cells (x)
    size_y: int = 1024                 # finest grid cells (y)
    levels: int = 3                    # pyramid depth
    start_coords: Tuple[float, float] = (0.5, 0.5)  # map origin fraction

    def level_resolution(self, level: int) -> float:
        # C++ builds this by repeated *=2.0f on a float32; for the default
        # power-of-two ladder the result is exact either way.
        return self.resolution * float(2 ** level)

    def level_size(self, level: int) -> Tuple[int, int]:
        # integer halving per level (Eigen Vector2i /= 2)
        sx, sy = self.size_x, self.size_y
        for _ in range(level):
            sx //= 2
            sy //= 2
        return sx, sy

    @property
    def top_left_offset(self) -> Tuple[float, float]:
        # MapRepMultiMap.h:53-57: totalMapSize * startCoords, shared by all
        # levels (so they cover the same world rectangle).
        return (
            self.resolution * float(self.size_x) * self.start_coords[0],
            self.resolution * float(self.size_y) * self.start_coords[1],
        )

    def level_scale(self, level: int) -> float:
        """world->map scale for a level: the f32 division 1.0f/cellLength
        (GridMapBase.h:270) — NOT the f64 reciprocal, which can differ by
        an ulp (e.g. 1/0.025f)."""
        import numpy as np
        res32 = np.float32(self.level_resolution(level))
        return float(np.float32(1.0) / res32)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Gauss-Newton scan matcher parameters (ScanMatcher.h:54-226)."""

    iterations_finest: int = 5         # MapRepMultiMap.h:125
    iterations_coarse: int = 3         # MapRepMultiMap.h:128
    # NOTE: the reference runs (iterations + 1) GN steps: one call before
    # the loop plus `iterations` in the loop (ScanMatcher.h:74,94).
    angle_step_clamp: float = 0.2      # |dtheta| per GN step (ScanMatcher.h:209-215)


@dataclasses.dataclass(frozen=True)
class UpdateConfig:
    """Map update parameters (GridMapLogOdds.h, OccGridMapBase.h).

    ``cell_model`` selects the per-cell representation — "log_odds"
    (default), "simple_count", or "reflectance" — the reference's three
    cell types, there selectable only by editing the GridMap typedef
    (map/GridMap.h:39-41); see core/cell_models.py.
    """

    update_factor_free: float = 0.4        # HectorMappingRos.cpp:72
    update_factor_occupied: float = 0.9    # HectorMappingRos.cpp:73
    log_odds_clamp_occupied: float = 50.0  # GridMapLogOdds.h:137
    cell_model: str = "log_odds"

    @staticmethod
    def _prob_to_log_odds(p: float) -> float:
        # Match the reference's probToLogOdds (GridMapLogOdds.h:199-203)
        # to the bit: odds is an f32 division, the unqualified C++
        # ``log(odds)`` promotes to double and the float return rounds
        # back — i.e. f32(log(f64(f32(p)/f32(1-p)))).
        import numpy as np
        pf = np.float32(p)
        odds = pf / (np.float32(1.0) - pf)
        return float(np.float32(math.log(float(odds))))

    @property
    def log_odds_free(self) -> float:
        return self._prob_to_log_odds(self.update_factor_free)

    @property
    def log_odds_occupied(self) -> float:
        return self._prob_to_log_odds(self.update_factor_occupied)


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Top-level engine config (HectorSlamProcessor.h + node params)."""

    map: MapConfig = MapConfig()
    match: MatchConfig = MatchConfig()
    update: UpdateConfig = UpdateConfig()
    # map-update pose gate (HectorSlamProcessor.h:89-95; node defaults
    # HectorMappingRos.cpp:75-76)
    map_update_distance_thresh: float = 0.4
    map_update_angle_thresh: float = 0.9
    # static scan geometry: beams are padded to this many points so every
    # step has one shape. 1081 (UTM-30LX) pads to 1152 = 9*128,
    # a multiple of the 128-lane VPU width.
    max_beams: int = 1152
    # Static cap on free cells per ray for the map-update scatter.
    # 0 (default) auto-derives the worst-case in-map geometry bound,
    # max(size_x, size_y): a Bresenham line between two in-map cells has
    # dominant-axis span <= size-1, so NO in-map beam can ever truncate —
    # matching the reference, which marks every cell unconditionally
    # (OccGridMapBase.h:243-260). Setting it lower (e.g. sensor range /
    # resolution for a range-filtered scan source) trades a little update
    # cost for a cap that the scan pipeline must honour; any cells a
    # too-long beam drops are counted in StepMetrics.truncated_free_cells.
    max_ray_cells: int = 0

    @property
    def resolved_max_ray_cells(self) -> int:
        if self.max_ray_cells > 0:
            return self.max_ray_cells
        return max(self.map.size_x, self.map.size_y)

    def level_max_ray_cells(self, level: int) -> int:
        k = self.resolved_max_ray_cells
        for _ in range(level):
            k = (k + 1) // 2
        # keep a small safety margin and 8-alignment
        return max(8, ((k + 9) // 8) * 8)


# Tutorial configuration (hector_slam_launch/launch/tutorial.launch via
# mapping_default.launch: resolution 0.05, size 2048, 2 levels,
# gate 0.4 m / 0.06 rad).
TUTORIAL_CONFIG = SlamConfig(
    map=MapConfig(resolution=0.05, size_x=2048, size_y=2048, levels=2),
    map_update_distance_thresh=0.4,
    map_update_angle_thresh=0.06,
    # sensor-derived cap: UTM-30LX 30 m / 0.05 m = 600 cells + rounding
    # margin; exact for range-filtered scans, divergences (if a caller
    # feeds longer synthetic beams) are counted in truncated_free_cells
    max_ray_cells=640,
)

# Benchmark configuration from BASELINE.json config 1/4: 1024^2 @ 0.05 m.
BENCH_CONFIG = SlamConfig(
    map=MapConfig(resolution=0.05, size_x=1024, size_y=1024, levels=3),
    max_ray_cells=640,  # sensor-derived: 30 m / 0.05 m + margin
)

# Height-mapping configuration (hector_slam_launch/launch/
# height_mapping.launch: known poses, thresholds 0 so every scan maps,
# z-band filtering done by the caller via process_points(z_min, z_max)).
HEIGHT_MAPPING_CONFIG = SlamConfig(
    map=MapConfig(resolution=0.05, size_x=1024, size_y=1024, levels=2),
    map_update_distance_thresh=0.0,
    map_update_angle_thresh=0.0,
    max_ray_cells=640,
)

# Single-map configuration (slam_main/MapRepSingleMap.h:49,79: one
# 1024^2 level, 20 GN iterations — the unused alternative representation).
SINGLE_MAP_CONFIG = SlamConfig(
    map=MapConfig(resolution=0.025, size_x=1024, size_y=1024, levels=1),
    match=MatchConfig(iterations_finest=20),
)

# The remaining hector_slam_launch variants, mirrored preset-for-launch
# (frames/topics are ROS plumbing with no engine equivalent; engine
# parameters are reproduced exactly):

# mapping_box.launch: 2048^2 @ 0.05 m (node-default 3 levels), tutorial
# gate 0.4 m / 0.06 rad, centered start.
MAPPING_BOX_CONFIG = SlamConfig(
    map=MapConfig(resolution=0.05, size_x=2048, size_y=2048, levels=3),
    map_update_distance_thresh=0.4,
    map_update_angle_thresh=0.06,
    max_ray_cells=640,
)

# cityflyer_logfile_processing.launch (log replay, MAV): 2048^2 @ 0.05 m,
# 3 levels, off-center start (0.75, 0.25), occupied factor 0.95, tight
# gate 0.3 m / 0.03 rad.
CITYFLYER_LOG_CONFIG = SlamConfig(
    map=MapConfig(resolution=0.05, size_x=2048, size_y=2048, levels=3,
                  start_coords=(0.75, 0.25)),
    update=UpdateConfig(update_factor_free=0.4,
                        update_factor_occupied=0.95),
    map_update_distance_thresh=0.3,
    map_update_angle_thresh=0.03,
    max_ray_cells=640,
)

# hector_ugv.launch: 1024^2 @ 0.05 m SINGLE level, free factor 0.3
# (node-default gate); laser z-band [-0.3, node-default] is applied by
# the caller via SlamSession.process_points(z_min=-0.3).
UGV_CONFIG = SlamConfig(
    map=MapConfig(resolution=0.05, size_x=1024, size_y=1024, levels=1),
    update=UpdateConfig(update_factor_free=0.3),
    max_ray_cells=640,
)

# pr2os.launch sets exactly the mapping_default engine parameters, and
# mpo700_mapping / postproc_data / postproc_qut_logs include
# mapping_default directly (only frames/topics differ — ROS plumbing
# with no engine equivalent), so all four map to the tutorial preset.
PR2_CONFIG = TUTORIAL_CONFIG

DEFAULT_CONFIG = SlamConfig()
