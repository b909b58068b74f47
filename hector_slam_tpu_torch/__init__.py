"""hector_slam_tpu_torch — the PyTorch/CUDA port of hector_slam_tpu.

The same engine on one NVIDIA H100: plain tensor code in PyTorch, and
every kernel the JAX package wrote in Pallas for the TPU written by hand
in CUDA C++ for Hopper (``csrc/``). It imports nothing of JAX or of the
JAX package. Entry points put their tensors on the card unless the
caller passes ``device="cpu"``, and raise when no card is present.
"""

from .config import (BENCH_CONFIG, CITYFLYER_LOG_CONFIG, DEFAULT_CONFIG,
                     HEIGHT_MAPPING_CONFIG, MAPPING_BOX_CONFIG, PR2_CONFIG,
                     SINGLE_MAP_CONFIG, TUTORIAL_CONFIG, UGV_CONFIG,
                     MapConfig, MatchConfig, SlamConfig, UpdateConfig)
from .convert import fleet_state_from_numpy, scan_from_numpy, state_from_numpy
from .core.mapping import update_pyramid
from .core.matcher import match_level, match_pyramid
from .core.slam import init_state, run_log, slam_step
from .io.scanlog import LaserModel, load_log, scan_from_ranges, stack_scans
from .ops.interp_moments import interp_moments, interp_moments_plain
from .ops.paint_cells import paint_cells, paint_cells_plain
from .parallel.batch import (best_hypothesis, fleet_step, init_fleet,
                             match_hypotheses, residual_for_poses)
from .parallel.kernel_match import MatchDiag, match_hypotheses_kernel
from .parallel.shared_map import init_shared_fleet, shared_fleet_step
from .types import MatchResult, Scan, SlamState, StepMetrics

__all__ = [
    "BENCH_CONFIG", "CITYFLYER_LOG_CONFIG", "DEFAULT_CONFIG",
    "HEIGHT_MAPPING_CONFIG", "MAPPING_BOX_CONFIG", "PR2_CONFIG",
    "SINGLE_MAP_CONFIG", "TUTORIAL_CONFIG", "UGV_CONFIG",
    "MapConfig", "MatchConfig", "SlamConfig", "UpdateConfig",
    "fleet_state_from_numpy", "scan_from_numpy", "state_from_numpy",
    "update_pyramid", "match_level", "match_pyramid",
    "init_state", "run_log", "slam_step",
    "LaserModel", "load_log", "scan_from_ranges", "stack_scans",
    "interp_moments", "interp_moments_plain",
    "paint_cells", "paint_cells_plain",
    "best_hypothesis", "fleet_step", "init_fleet", "match_hypotheses",
    "residual_for_poses", "init_shared_fleet", "shared_fleet_step",
    "MatchDiag", "match_hypotheses_kernel",
    "MatchResult", "Scan", "SlamState", "StepMetrics",
]
