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
from .convert import scan_from_numpy, state_from_numpy
from .core.matcher import match_pyramid
from .core.slam import init_state, run_log, slam_step
from .io.scanlog import LaserModel, load_log, scan_from_ranges, stack_scans
from .ops.interp_moments import interp_moments, interp_moments_plain
from .parallel.kernel_match import MatchDiag, match_hypotheses_kernel
from .types import MatchResult, Scan, SlamState, StepMetrics

__all__ = [
    "BENCH_CONFIG", "CITYFLYER_LOG_CONFIG", "DEFAULT_CONFIG",
    "HEIGHT_MAPPING_CONFIG", "MAPPING_BOX_CONFIG", "PR2_CONFIG",
    "SINGLE_MAP_CONFIG", "TUTORIAL_CONFIG", "UGV_CONFIG",
    "MapConfig", "MatchConfig", "SlamConfig", "UpdateConfig",
    "scan_from_numpy", "state_from_numpy", "match_pyramid",
    "init_state", "run_log", "slam_step",
    "LaserModel", "load_log", "scan_from_ranges", "stack_scans",
    "interp_moments", "interp_moments_plain",
    "MatchDiag", "match_hypotheses_kernel",
    "MatchResult", "Scan", "SlamState", "StepMetrics",
]
