"""State and result types of the PyTorch engine: NamedTuples of tensors,
field for field the pytrees of ``hector_slam_tpu/types.py``.

The whole SLAM state is one NamedTuple (replaces the reference's mutable
GridMap + HectorSlamProcessor members, slam_main/HectorSlamProcessor.h:
141-147). Functions take and return these; the device is chosen once, by
the entry points, and every tensor of a state lies on it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def host_array(x) -> np.ndarray:
    """A numpy array of ``x``: a tensor on any device (copied to the
    host), a numpy array or a sequence."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for. ``"cuda"`` without a card
    raises: the entry points never drop to the CPU on their own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hector_slam_tpu_torch: device 'cuda' was requested but no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev


class Scan(NamedTuple):
    """A laser scan in the DataContainer convention
    (scan/DataPointContainer.h:92-96): beam endpoints in map-scale units
    of the finest level relative to the robot, plus the sensor origin
    ``origo`` in the same units. Fixed-size with a validity mask."""

    points: torch.Tensor   # f32[N, 2]
    origo: torch.Tensor    # f32[2]
    mask: torch.Tensor     # bool[N] — True for real beams, False for padding


class MatchResult(NamedTuple):
    pose: torch.Tensor      # f32[3] world (x, y, theta)
    hessian: torch.Tensor   # f32[3, 3] raw H from the finest level
    #                         (the reference's "covariance", ScanMatcher.h:184)


class SlamState(NamedTuple):
    """Full engine state. ``log_odds`` is the multi-resolution pyramid as a
    tuple of independent grids (MapRepMultiMap.h:134-147), layout
    ``log_odds[level][y, x]`` (row-major flat index y*size_x + x)."""

    log_odds: Tuple[torch.Tensor, ...]    # (f32[H_i, W_i], ...) per level
    pose: torch.Tensor                    # f32[3] last scan-match pose (world)
    last_map_update_pose: torch.Tensor    # f32[3] pose gate reference
    covariance: torch.Tensor              # f32[3,3] last raw Hessian
    step: torch.Tensor                    # i32[] scan counter
    map_update_count: torch.Tensor        # i32[] number of accepted updates
    quads: Tuple[torch.Tensor, ...] = ()  # (f32[H_i*W_i, 4], ...) per level:
    #   quad-packed probability grids derived from log_odds, recomputed
    #   only when the map-update gate fires (the reference's epoch cache,
    #   GridMapCacheArray.h:69-72)


class StepMetrics(NamedTuple):
    """Per-scan observability (src/HectorDebugInfoProvider.h:58-80)."""

    pose_delta: torch.Tensor        # f32[3] pose change this step
    map_updated: torch.Tensor       # bool[] gate decision
    hessian_det: torch.Tensor       # f32[] det of final H
    num_valid_beams: torch.Tensor   # i32[]
    truncated_free_cells: torch.Tensor  # i32[] cells dropped by the
    #   max_ray_cells cap this step (0 under the default auto cap)
