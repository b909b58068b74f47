"""Shared-map fleet SLAM: R robots matching against and integrating into
ONE map pyramid.

Counterpart of ``hector_slam_tpu/parallel/shared_map.py``, which shows why
it is exact: the map update is built from commutative boolean cell sets
(core/mapping.py: free/occupied masks, occupied wins, once-per-scan
dedup, OccGridMapBase.h:216-241). OR-combining the gated robots' sets
before ONE log-odds application gives every cell at most one free and one
occupied delta per fleet step, and occupied wins across robots as it wins
across beams: the reference's per-scan semantics with "scan" = the union
of the gated robots' scans.

Here the OR costs nothing extra: every gated robot's indices go into one
[H*W] paint per cell set and level, and painting them into one grid IS
the union (core/mapping.update_pyramid on a pyramid with no robot axis).

Each robot keeps its own pose, covariance and gate reference; robots
whose gate has not fired contribute nothing (their beams are masked).
The shared pyramid and its quad cache change once per step iff some gate
fired, and a step where none fired skips the rasterization (one host
sync per step decides).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..core.grid import pose_difference_larger_than
from ..core.mapping import update_pyramid
from ..core.matcher import match_pyramid
from ..core.slam import init_state, quads_of
from ..ops.solve3 import det3
from ..types import Scan, SlamState, StepMetrics


def init_shared_fleet(cfg: SlamConfig, num_robots: int, start_poses=None,
                      device="cuda") -> SlamState:
    """One shared pyramid; per-robot pose/covariance/gate leaves carry a
    leading robot axis, ``step`` and ``map_update_count`` stay shared.
    ``start_poses`` f32[R, 3] seeds each robot's world pose (a fleet needs
    one common frame; defaults to all zeros). On ``device``, the card
    unless the caller asks for the CPU."""
    one = init_state(cfg, device)
    dev = one.pose.device
    if start_poses is None:
        poses = torch.zeros((num_robots, 3), dtype=torch.float32, device=dev)
    else:
        poses = torch.as_tensor(start_poses, dtype=torch.float32).to(dev)
        if tuple(poses.shape) != (num_robots, 3):
            raise ValueError(f"start_poses has shape {tuple(poses.shape)}, "
                             f"expected ({num_robots}, 3)")
    flt_max = float(np.finfo(np.float32).max)
    return one._replace(
        pose=poses,
        last_map_update_pose=torch.full((num_robots, 3), flt_max,
                                        dtype=torch.float32, device=dev),
        covariance=torch.zeros((num_robots, 3, 3), dtype=torch.float32,
                               device=dev),
    )


def shared_fleet_step(
    state: SlamState,   # shared pyramid; pose [R, 3] etc.
    scans: Scan,        # leading robot axis: points [R, N, 2], ...
    cfg: SlamConfig,
    map_without_matching: bool = False,
) -> Tuple[SlamState, StepMetrics]:
    """One fleet step: every robot scan-matches against the SHARED map,
    per-robot pose gates fire independently, and all gated scans integrate
    into the shared pyramid as one combined update.
    ``map_without_matching`` takes the state's poses as they are and gates
    every robot (HectorSlamProcessor.h:77-81,89)."""
    if map_without_matching:
        new_poses = state.pose
        hessians = state.covariance
        gates = torch.ones(new_poses.shape[:1], dtype=torch.bool,
                           device=new_poses.device)
    else:
        result = match_pyramid(state.log_odds, state.pose, scans, cfg,
                               quads=state.quads)
        new_poses = result.pose
        hessians = result.hessian
        gates = pose_difference_larger_than(
            new_poses, state.last_map_update_pose,
            cfg.map_update_distance_thresh, cfg.map_update_angle_thresh)

    any_gate = bool(gates.any())   # the one host sync per step
    if any_gate:
        new_log_odds, truncated = update_pyramid(
            state.log_odds, new_poses, scans, cfg, gates)
        truncated_total = truncated.sum().to(torch.int32)
        new_quads = quads_of(new_log_odds, cfg.update.cell_model)
    else:
        new_log_odds, new_quads = state.log_odds, state.quads
        truncated_total = torch.zeros((), dtype=torch.int32,
                                      device=gates.device)

    metrics = StepMetrics(
        pose_delta=new_poses - state.pose,
        map_updated=gates,
        hessian_det=det3(hessians),
        num_valid_beams=scans.mask.sum(-1).to(torch.int32),
        truncated_free_cells=truncated_total,
    )
    new_state = state._replace(
        log_odds=new_log_odds,
        pose=new_poses,
        last_map_update_pose=torch.where(gates[:, None], new_poses,
                                         state.last_map_update_pose),
        covariance=hessians,
        step=state.step + 1,
        map_update_count=state.map_update_count + int(any_gate),
        quads=new_quads,
    )
    return new_state, metrics
