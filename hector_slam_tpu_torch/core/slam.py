"""SLAM orchestration: the match -> gate -> map-update step.

Counterpart of ``hector_slam_tpu/core/slam.py`` (HectorSlamProcessor,
slam_main/HectorSlamProcessor.h:52-139). ``slam_step`` is a function
``(SlamState, Scan) -> (SlamState, StepMetrics)``; the JAX package's two
``lax.cond`` on the gate become one host branch, so each scan costs one
device->host sync (the gate bit).

Replicated behaviours:
  - map_without_matching accepts the pose hint verbatim and forces the map
    update (HectorSlamProcessor.h:77-81,89)
  - the map-update gate: integrate only if the pose moved more than the
    distance OR angle threshold since the last accepted update
    (HectorSlamProcessor.h:89-95, util/UtilFunctions.h:73-92)
  - reset seeds last_map_update_pose with FLT_MAX so the first scan always
    maps (HectorSlamProcessor.h:115-124)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..types import Scan, SlamState, StepMetrics, resolve_device
from ..ops.solve3 import det3
from .grid import init_log_odds_pyramid, pose_difference_larger_than
from .interp import quad_pack_storage
from .mapping import update_pyramid
from .matcher import match_pyramid


def quads_of(log_odds_pyramid, cell_model: str):
    """Per-level quad-packed prob grids — the matcher's cached view of the
    map (the GridMapCacheArray epoch cache); per robot for a pyramid with
    a leading robot axis."""
    return tuple(quad_pack_storage(lo, cell_model) for lo in log_odds_pyramid)


def init_state(cfg: SlamConfig, device="cuda") -> SlamState:
    """Fresh state == HectorSlamProcessor::reset (HectorSlamProcessor.h:115),
    on ``device`` (the card unless the caller asks for the CPU; raises if
    the card is asked for and absent)."""
    dev = resolve_device(device)
    flt_max = float(np.finfo(np.float32).max)
    log_odds = init_log_odds_pyramid(cfg.map, cfg.update.cell_model, dev)
    return SlamState(
        log_odds=log_odds,
        pose=torch.zeros(3, dtype=torch.float32, device=dev),
        last_map_update_pose=torch.full((3,), flt_max, dtype=torch.float32,
                                        device=dev),
        covariance=torch.zeros((3, 3), dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        map_update_count=torch.zeros((), dtype=torch.int32, device=dev),
        quads=quads_of(log_odds, cfg.update.cell_model),
    )


def slam_step(
    state: SlamState,
    scan: Scan,
    cfg: SlamConfig,
    pose_hint: Optional[torch.Tensor] = None,
    map_without_matching: bool = False,
) -> Tuple[SlamState, StepMetrics]:
    """One scan update (HectorSlamProcessor::update, :71-113).

    ``pose_hint`` defaults to the last scan-match pose (the node's default
    start estimate, HectorMappingRos.cpp:313-315)."""
    hint = state.pose if pose_hint is None else pose_hint
    if map_without_matching:
        new_pose = hint
        hessian = state.covariance
        do_update = torch.ones((), dtype=torch.bool, device=hint.device)
    else:
        result = match_pyramid(state.log_odds, hint, scan, cfg,
                               quads=state.quads)
        new_pose = result.pose
        hessian = result.hessian
        do_update = pose_difference_larger_than(
            new_pose, state.last_map_update_pose,
            cfg.map_update_distance_thresh, cfg.map_update_angle_thresh)

    if bool(do_update):   # the one host sync per scan
        new_log_odds, truncated = update_pyramid(state.log_odds, new_pose,
                                                 scan, cfg)
        new_last_update_pose = new_pose
        # refresh the cached quads only when the map changed (the
        # reference's epoch-cache invalidation, MapRepMultiMap.h:107-114)
        new_quads = quads_of(new_log_odds, cfg.update.cell_model)
    else:
        new_log_odds = state.log_odds
        truncated = torch.zeros((), dtype=torch.int32, device=hint.device)
        new_last_update_pose = state.last_map_update_pose
        new_quads = state.quads

    new_state = SlamState(
        log_odds=new_log_odds,
        pose=new_pose,
        last_map_update_pose=new_last_update_pose,
        covariance=hessian,
        step=state.step + 1,
        map_update_count=state.map_update_count + do_update.to(torch.int32),
        quads=new_quads,
    )
    metrics = StepMetrics(
        pose_delta=new_pose - state.pose,
        map_updated=do_update,
        hessian_det=det3(hessian),
        num_valid_beams=scan.mask.sum().to(torch.int32),
        truncated_free_cells=truncated,
    )
    return new_state, metrics


def run_log(state: SlamState, scans: Scan, cfg: SlamConfig):
    """Sequential replay over a stacked scan log (leading time axis).

    Returns (final state, poses f32[T,3], metrics stacked over T). A log
    of no scans returns the state unchanged, poses f32[0,3] and metrics of
    length 0, as the JAX package's ``lax.scan`` does."""
    poses, metrics = [], []
    for t in range(scans.points.shape[0]):
        state, m = slam_step(state, Scan(scans.points[t], scans.origo[t],
                                         scans.mask[t]), cfg)
        poses.append(state.pose)
        metrics.append(m)
    if not metrics:
        dev = state.pose.device

        def empty(*shape, dtype=torch.float32):
            return torch.zeros((0, *shape), dtype=dtype, device=dev)

        return state, empty(3), StepMetrics(
            pose_delta=empty(3), map_updated=empty(dtype=torch.bool),
            hessian_det=empty(), num_valid_beams=empty(dtype=torch.int32),
            truncated_free_cells=empty(dtype=torch.int32))
    return (state, torch.stack(poses),
            StepMetrics(*(torch.stack(f) for f in zip(*metrics))))
