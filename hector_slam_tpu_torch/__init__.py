"""hector_slam_tpu_torch — the PyTorch/CUDA port of hector_slam_tpu.

The same engine on one NVIDIA H100: plain tensor code in PyTorch, and
every kernel the JAX package wrote in Pallas for the TPU written by hand
in CUDA C++ for Hopper (``csrc/``). It imports nothing of JAX or of the
JAX package. Entry points put their tensors on the card unless the
caller passes ``device="cpu"``, and raise when no card is present. The
``*_jit`` entry points are the JAX package's compiled ones: on the card
each replays a CUDA graph of a body that reads nothing on the host
(``core/graphs.py``).
"""

from .config import (BENCH_CONFIG, CITYFLYER_LOG_CONFIG, DEFAULT_CONFIG,
                     HEIGHT_MAPPING_CONFIG, MAPPING_BOX_CONFIG, PR2_CONFIG,
                     SINGLE_MAP_CONFIG, TUTORIAL_CONFIG, UGV_CONFIG,
                     MapConfig, MatchConfig, SlamConfig, UpdateConfig)
from .convert import fleet_state_from_numpy, scan_from_numpy, state_from_numpy
from .core.debug import match_pyramid_debug, match_pyramid_debug_jit
from .core.mapping import update_pyramid
from .core.matcher import match_level, match_pyramid
from .core.slam import (init_state, run_log, run_log_jit, slam_step,
                        slam_step_jit)
from .export.geotiff import GeotiffExporter, write_geotiff
from .export.markers import arrow_marker, covariance_ellipse, pose_markers
from .export.images import map_tile_image, map_to_image, write_pgm, write_png
from .export.occupancy import (GridMeta, grid_meta, map_extends,
                               to_occupancy_grid, to_occupancy_grid_jax,
                               to_occupancy_grid_tensor)
from .export.pose_output import (covariance_6x6, covariance_world_coords,
                                 pose_stamped, quaternion_to_yaw,
                                 yaw_to_quaternion)
from .export.trajectory import RecoveryInfo, TrajectoryRecorder
from .io.checkpoint import (load_state, load_state_dcp, save_state,
                            save_state_dcp)
from .io.scanlog import (LaserModel, load_log, save_log, scan_from_points,
                         scan_from_ranges, stack_scans)
from .ops.interp_moments import interp_moments, interp_moments_plain
from .ops.paint_cells import paint_cells, paint_cells_plain
from .parallel.batch import (best_hypothesis, fleet_step, fleet_step_jit,
                             init_fleet, match_hypotheses,
                             match_hypotheses_jit, residual_for_poses)
from .parallel.kernel_match import (MatchDiag, match_hypotheses_kernel,
                                    match_hypotheses_kernel_jit)
from .parallel.onehot_match import (match_hypotheses_mxu,
                                    match_hypotheses_mxu_jit)
from .parallel.pallas_match import (match_hypotheses_pallas,
                                    match_hypotheses_pallas_jit)
from .parallel.recovery import auto_prune_top_k, prune_hypotheses_coarse
from .parallel.shared_map import (init_shared_fleet, shared_fleet_step,
                                  shared_fleet_step_jit)
from .query.raycast import (distance_to_obstacle, distance_to_obstacle_batch,
                            get_distance_to_obstacle, get_normal,
                            get_search_position)
from .fleet_session import FleetSession
from .session import SlamSession
from .types import MatchResult, Scan, SlamState, StepMetrics

__all__ = [
    "BENCH_CONFIG", "CITYFLYER_LOG_CONFIG", "DEFAULT_CONFIG",
    "HEIGHT_MAPPING_CONFIG", "MAPPING_BOX_CONFIG", "PR2_CONFIG",
    "SINGLE_MAP_CONFIG", "TUTORIAL_CONFIG", "UGV_CONFIG",
    "MapConfig", "MatchConfig", "SlamConfig", "UpdateConfig",
    "fleet_state_from_numpy", "scan_from_numpy", "state_from_numpy",
    "update_pyramid", "match_level", "match_pyramid", "match_pyramid_debug",
    "match_pyramid_debug_jit",
    "init_state", "run_log", "run_log_jit", "slam_step", "slam_step_jit",
    "GeotiffExporter", "write_geotiff",
    "arrow_marker", "covariance_ellipse", "pose_markers",
    "map_tile_image", "map_to_image", "write_pgm", "write_png",
    "GridMeta", "grid_meta", "map_extends", "to_occupancy_grid",
    "to_occupancy_grid_jax", "to_occupancy_grid_tensor",
    "covariance_6x6", "covariance_world_coords", "pose_stamped",
    "quaternion_to_yaw", "yaw_to_quaternion",
    "RecoveryInfo", "TrajectoryRecorder",
    "load_state", "save_state", "load_state_dcp", "save_state_dcp",
    "LaserModel", "load_log", "save_log", "scan_from_points",
    "scan_from_ranges", "stack_scans",
    "interp_moments", "interp_moments_plain",
    "paint_cells", "paint_cells_plain",
    "best_hypothesis", "fleet_step", "fleet_step_jit", "init_fleet",
    "match_hypotheses", "match_hypotheses_jit", "residual_for_poses",
    "init_shared_fleet", "shared_fleet_step", "shared_fleet_step_jit",
    "MatchDiag", "match_hypotheses_kernel", "match_hypotheses_kernel_jit",
    "match_hypotheses_mxu", "match_hypotheses_mxu_jit",
    "match_hypotheses_pallas", "match_hypotheses_pallas_jit",
    "auto_prune_top_k", "prune_hypotheses_coarse", "SlamSession",
    "FleetSession",
    "distance_to_obstacle", "distance_to_obstacle_batch",
    "get_distance_to_obstacle", "get_normal", "get_search_position",
    "MatchResult", "Scan", "SlamState", "StepMetrics",
]
