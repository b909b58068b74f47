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
the union (core/mapping.paint_pyramid on a pyramid with no robot axis).

Each robot keeps its own pose, covariance and gate reference; robots
whose gate has not fired contribute nothing (their beams are masked).
The combined cell sets are painted on every step, and the update writes
the shared pyramid and its quads only where the any-gate, read on the
device, is set (JAX's ``jnp.where(any_gate, updated, lo)``).
``shared_fleet_step_jit`` replays this body as a CUDA graph on the card
(core/graphs.py), with an NCCL group's all-reduces inside it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..core import graphs
from ..core.collectives import captures_collectives, por, psum
from ..core.grid import pose_difference_larger_than
from ..core.mapping import integrate_sets, paint_pyramid
from ..core.matcher import match_pyramid
from ..core.slam import compiled_step, init_state
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
    robot_axis=None,
    *,
    in_place: bool = False,
) -> Tuple[SlamState, StepMetrics]:
    """One fleet step: every robot scan-matches against the SHARED map,
    per-robot pose gates fire independently, and all gated scans integrate
    into the shared pyramid as one combined update, written with its
    quads only where the any-gate is set, read on the device (JAX's
    ``jnp.where(any_gate, updated, lo)``,
    hector_slam_tpu/parallel/shared_map.py:138); the update count is
    added on the device. ``map_without_matching`` takes the state's poses
    as they are and gates every robot (HectorSlamProcessor.h:77-81,89).
    ``in_place``: written into the state's own maps (a donating step);
    otherwise the state is left as it was.

    ``robot_axis``: the process group over which the robots are sharded,
    each rank holding the same replicated pyramid
    (parallel/sharded.make_shared_fleet_step). The any-gate bit and the
    cell sets are OR-combined over it and the truncated count summed
    (hector_slam_tpu/parallel/shared_map.py:102-159) on every step, so
    every rank issues the same collectives whether a gate fired or not;
    the OR commutes, so every rank's map stays bit-equal to the
    unsharded step's."""
    new_poses, hessians, gates = _match_and_gate(state, scans, cfg,
                                                 map_without_matching)
    [any_gate] = por([gates.any()], robot_axis)
    sets, truncated = paint_pyramid(state.log_odds, new_poses, scans, cfg,
                                    robot_axis, gates=gates)
    new_log_odds, new_quads = integrate_sets(
        state.log_odds, state.quads, sets, any_gate, cfg, in_place)
    truncated_total = psum(truncated.sum().to(torch.int32), robot_axis)
    return _result(state, scans, new_poses, hessians, gates,
                   state.map_update_count + any_gate.to(torch.int32),
                   new_log_odds, new_quads,
                   torch.where(any_gate, truncated_total, 0))


def _match_and_gate(state, scans, cfg, map_without_matching):
    """Every robot's new pose, Hessian and gate."""
    if map_without_matching:
        return (state.pose, state.covariance,
                torch.ones(state.pose.shape[:1], dtype=torch.bool,
                           device=state.pose.device))
    result = match_pyramid(state.log_odds, state.pose, scans, cfg,
                           quads=state.quads)
    gates = pose_difference_larger_than(
        result.pose, state.last_map_update_pose,
        cfg.map_update_distance_thresh, cfg.map_update_angle_thresh)
    return result.pose, result.hessian, gates


def _result(state, scans, new_poses, hessians, gates, map_update_count,
            new_log_odds, new_quads, truncated_total):
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
        map_update_count=map_update_count,
        quads=new_quads,
    )
    return new_state, metrics


def shared_fleet_step_jit(
    state: SlamState,
    scans: Scan,
    cfg: SlamConfig,
    map_without_matching: bool = False,
    robot_axis=None,
) -> Tuple[SlamState, StepMetrics]:
    """``shared_fleet_step`` compiled (the JAX package's
    ``shared_fleet_step_jit``, hector_slam_tpu/parallel/shared_map.py:
    190): on the card a CUDA graph captured once per (``cfg``,
    ``map_without_matching``, the group, shapes, the shared map's memory)
    and replayed with no host round trip. The state is DONATED, as JAX's
    is (see ``slam_step_jit``); the metrics are new tensors. On CPU
    tensors the body runs eagerly.

    With ``robot_axis`` (a process group) the graph holds the group's
    all-reduces: an NCCL group's collectives are kernels on the card's
    streams, so they are captured and every replay issues them on every
    rank. A gloo group moves a CUDA tensor through host memory, which no
    CUDA graph can capture, so there the same body runs eagerly; the
    group's backend decides (core/collectives.captures_collectives)."""
    if not graphs.on_card(state.pose) or (
            robot_axis is not None and not captures_collectives(robot_axis)):
        return shared_fleet_step(state, scans, cfg, map_without_matching,
                                 robot_axis)
    return compiled_step(
        "shared_fleet_step_jit", (cfg, map_without_matching, robot_axis),
        state, scans,
        lambda st, points, origo, mask, in_place: shared_fleet_step(
            st, Scan(points, origo, mask), cfg, map_without_matching,
            robot_axis, in_place=in_place))
