"""SLAM orchestration: the match -> gate -> map-update step.

Counterpart of ``hector_slam_tpu/core/slam.py`` (HectorSlamProcessor,
slam_main/HectorSlamProcessor.h:52-139). ``slam_step`` is a function
``(SlamState, Scan) -> (SlamState, StepMetrics)`` with no host read: the
JAX package's ``lax.cond`` on the gate becomes its select form
(hector_slam_tpu/core/slam.py:124-131). The cell sets are painted on
every scan, and the map tail (core/mapping.integrate_sets) writes the
levels and packs the quads only where the gate, read on the device,
fired.

The compiled entry points (``slam_step_jit``, ``match_phase_jit``,
``update_phase_jit``, ``run_log_jit``) run the same body: on CUDA tensors
it is captured once per static signature as a CUDA graph
(core/graphs.py), which updates the donated maps in place, and replayed
with no host round trip; on CPU tensors it runs eagerly.

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

from .. import tracing
from ..config import SlamConfig
from ..types import Scan, SlamState, StepMetrics, resolve_device
from ..ops.solve3 import det3
from . import graphs
from .collectives import psum
from .grid import init_log_odds_pyramid, pose_difference_larger_than
from .interp import quad_pack_storage
from .mapping import integrate_sets, paint_pyramid
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


def match_phase(
    state: SlamState,
    scan: Scan,
    cfg: SlamConfig,
    pose_hint: Optional[torch.Tensor] = None,
    map_without_matching: bool = False,
    beam_axis=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The match half of ``slam_step`` (the JAX package's
    ``match_phase_jit``): returns (new_pose, hessian) for
    ``update_phase``. ``pose_hint`` defaults to the last scan-match pose
    (the node's default start estimate, HectorMappingRos.cpp:313-315);
    ``map_without_matching`` takes the hint verbatim
    (HectorSlamProcessor.h:77-81). ``beam_axis``: see ``slam_step``."""
    hint = state.pose if pose_hint is None else pose_hint
    if map_without_matching:
        return hint, state.covariance
    result = match_pyramid(state.log_odds, hint, scan, cfg, quads=state.quads,
                           beam_axis=beam_axis)
    return result.pose, result.hessian


def update_phase(
    state: SlamState,
    scan: Scan,
    cfg: SlamConfig,
    new_pose: torch.Tensor,
    hessian: torch.Tensor,
    map_without_matching: bool = False,
    beam_axis=None,
    raster_backend: Optional[str] = None,
    *,
    in_place: bool = False,
) -> Tuple[SlamState, StepMetrics]:
    """The gate -> map update -> state assembly half of ``slam_step``
    (HectorSlamProcessor.h:89-113; the JAX package's ``_finish_step`` /
    ``update_phase_jit``), decided on the device: the cell sets are
    painted on every scan, and the map update (``integrate_sets``) writes
    the levels and packs the quads only where the gate fired;
    ``torch.where`` keeps the last update pose and a zero truncated count
    where it did not. ``map_without_matching`` forces the update (:89).
    ``beam_axis``, ``raster_backend``: see ``slam_step``; the gate comes
    from the all-reduced match, and every rank of a beam group issues the
    update's collectives on every scan. ``in_place``: the new maps are
    written into the state's own levels and quads (a donating step);
    otherwise the state is left as it was."""
    do_update = _gate(state, cfg, new_pose, map_without_matching)
    tracing.count("update.runs")
    sets, truncated = paint_pyramid(
        state.log_odds, new_pose, scan, cfg, beam_axis, raster_backend)
    new_log_odds, new_quads = integrate_sets(
        state.log_odds, state.quads, sets, do_update, cfg, in_place)
    return _assemble(
        state, scan, new_pose, hessian, do_update, new_log_odds, new_quads,
        torch.where(do_update, psum(truncated, beam_axis), 0), beam_axis)


def _assemble(state, scan, new_pose, hessian, do_update, new_log_odds,
              new_quads, truncated, beam_axis):
    """The new state and the step's metrics (HectorSlamProcessor.h:
    97-113): step and update count are added on the device."""
    new_state = SlamState(
        log_odds=new_log_odds,
        pose=new_pose,
        last_map_update_pose=torch.where(do_update, new_pose,
                                         state.last_map_update_pose),
        covariance=hessian,
        step=state.step + 1,
        map_update_count=state.map_update_count + do_update.to(torch.int32),
        quads=new_quads,
    )
    metrics = StepMetrics(
        pose_delta=new_pose - state.pose,
        map_updated=do_update,
        hessian_det=det3(hessian),
        num_valid_beams=psum(scan.mask.sum().to(torch.int32), beam_axis),
        truncated_free_cells=truncated,
    )
    return new_state, metrics


def _gate(state, cfg, new_pose, map_without_matching):
    if map_without_matching:
        return torch.ones((), dtype=torch.bool, device=new_pose.device)
    return pose_difference_larger_than(
        new_pose, state.last_map_update_pose,
        cfg.map_update_distance_thresh, cfg.map_update_angle_thresh)


def slam_step(
    state: SlamState,
    scan: Scan,
    cfg: SlamConfig,
    pose_hint: Optional[torch.Tensor] = None,
    map_without_matching: bool = False,
    beam_axis=None,
    raster_backend: Optional[str] = None,
    *,
    in_place: bool = False,
) -> Tuple[SlamState, StepMetrics]:
    """One scan update (HectorSlamProcessor::update, :71-113): the two
    phases chained, so ``SlamSession(timing_mode="phases")`` computes what
    this does, op for op. The body that ``slam_step_jit`` and
    ``run_log_jit`` capture.

    ``beam_axis``: the ``torch.distributed`` process group over which the
    scan's beams are sharded (None: unsharded; parallel/sharded.py): the
    normal equations, the empty-scan test, the painted cell sets, the
    truncated and valid-beam counts are combined over it.
    ``raster_backend``: the map update's free-set layout
    (``core/mapping.update_pyramid``); None paints segment-compacted sets
    on the card without ``beam_axis``, dense ones elsewhere. Same cells
    either way. ``in_place``: as in ``update_phase``."""
    new_pose, hessian = match_phase(state, scan, cfg, pose_hint,
                                    map_without_matching, beam_axis)
    return update_phase(state, scan, cfg, new_pose, hessian,
                        map_without_matching, beam_axis, raster_backend,
                        in_place=in_place)


def _replay(state: SlamState, scans: Scan, step):
    """``step(state, scan)`` over a stacked scan log, eagerly: (final
    state, poses f32[T,3], metrics stacked over T), and for a log of no
    scans the state unchanged, poses f32[0,3] and length-0 metrics, as
    the JAX package's ``lax.scan`` gives."""
    poses, metrics = [], []
    for t in range(scans.points.shape[0]):
        state, m = step(state, Scan(scans.points[t], scans.origo[t],
                                    scans.mask[t]))
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


def run_log(state: SlamState, scans: Scan, cfg: SlamConfig):
    """Sequential replay over a stacked scan log (leading time axis):
    ``slam_step`` per scan.

    Returns (final state, poses f32[T,3], metrics stacked over T). A log
    of no scans returns the state unchanged, poses f32[0,3] and metrics of
    length 0, as the JAX package's ``lax.scan`` does."""
    return _replay(state, scans, lambda st, sc: slam_step(st, sc, cfg))


# ---- compiled entry points: CUDA graphs of the step bodies ---------------

def state_leaves(state: SlamState):
    """(map leaves: levels then quads, the five small leaves)."""
    if not state.quads:
        raise ValueError("the compiled steps need the state's quads "
                         "(init_state, state_from_numpy and load_state "
                         "give them)")
    return ([*state.log_odds, *state.quads],
            [state.pose, state.last_map_update_pose, state.covariance,
             state.step, state.map_update_count])


def state_from_leaves(maps, small) -> SlamState:
    """The state of ``state_leaves``' two lists."""
    levels = len(maps) // 2
    return SlamState(log_odds=tuple(maps[:levels]), pose=small[0],
                     last_map_update_pose=small[1], covariance=small[2],
                     step=small[3], map_update_count=small[4],
                     quads=tuple(maps[levels:]))


def _donate(into: SlamState, new: SlamState, write: bool) -> SlamState:
    """``new`` written into the donated state ``into`` and returned as
    ``into``'s tensors (``write``), or ``new`` as it is (a graph's
    warm-up, which writes nothing). Leaves that ``new`` shares with
    ``into`` (maps a step updated in place) are not copied."""
    if not write:
        return new
    dst, src = state_leaves(into), state_leaves(new)
    graphs.write_back(dst[0] + dst[1], src[0] + src[1])
    return into


def compiled_step(name: str, static_key, state: SlamState, inputs, step):
    """One replay of the donating graph of ``step(state, *inputs,
    in_place=...) -> (new state, metrics)``, a step body: the graph
    is keyed on the state's map memory, and the captured body updates the
    maps in place there (``in_place=True``; the warm-up before the
    capture writes nothing, ``in_place=False``), and writes the new small
    leaves (pose, gate reference, covariance, step, count) into the
    graph's own buffers, which it returns as the new state's and the next
    call overwrites. The metrics are fresh copies."""
    maps, small = state_leaves(state)

    def body(held, statics, write):
        st = state_from_leaves(held, statics[:5])
        new, metrics = step(st, *statics[5:], in_place=write)
        return _donate(st, new, write), metrics

    with graphs.use(name):
        graph = graphs.entry(name, static_key, maps, small + list(inputs),
                             body)
        graph.replay()
        new, metrics = graph.outputs
        return new, graphs.fresh(metrics)


def slam_step_jit(state: SlamState, scan: Scan, cfg: SlamConfig,
                  pose_hint: Optional[torch.Tensor] = None,
                  map_without_matching: bool = False):
    """Compiled per-scan step (the JAX package's ``slam_step_jit``,
    hector_slam_tpu/core/slam.py:169-176): ``slam_step``, on the card a
    CUDA graph captured once per static signature (``cfg``,
    ``map_without_matching``, whether ``pose_hint`` is given, the shapes
    and the state's map memory) and replayed with no host round trip.

    The state is DONATED, as JAX's is: its map levels and quads are
    updated in place, and the returned state's other leaves are the
    graph's buffers, which the next call overwrites. A caller that keeps
    a state from before a step clones it first. The metrics are new
    tensors. A capture or replay failure raises. On CPU tensors the body
    runs eagerly and nothing is donated."""
    if not graphs.on_card(state.pose):
        return slam_step(state, scan, cfg, pose_hint, map_without_matching)
    hint = [] if pose_hint is None else [pose_hint]
    return compiled_step(
        "slam_step_jit", (cfg, map_without_matching, pose_hint is not None),
        state, [*scan, *hint],
        lambda st, points, origo, mask, *h, in_place: slam_step(
            st, Scan(points, origo, mask), cfg, h[0] if h else None,
            map_without_matching, in_place=in_place))


def match_phase_jit(state: SlamState, scan: Scan, cfg: SlamConfig,
                    pose_hint: Optional[torch.Tensor] = None,
                    map_without_matching: bool = False):
    """The match half of ``slam_step_jit`` (the JAX package's
    ``match_phase_jit``, hector_slam_tpu/core/slam.py:179-193): (new_pose,
    hessian) for ``update_phase_jit``, as new tensors; the state is read,
    not donated. On the card a CUDA graph of ``match_phase``;
    ``map_without_matching`` matches nothing and returns the hint and the
    state's covariance, as ``match_phase`` does."""
    if not graphs.on_card(state.pose) or map_without_matching:
        return match_phase(state, scan, cfg, pose_hint, map_without_matching)
    start = state.pose if pose_hint is None else pose_hint
    return graphs.call(
        "match_phase_jit", (cfg,), state_leaves(state)[0],
        [start, *scan],
        lambda maps, statics: match_phase(
            state_from_leaves(maps, [statics[0]] + [None] * 4),
            Scan(*statics[1:4]), cfg))


def update_phase_jit(state: SlamState, scan: Scan, cfg: SlamConfig,
                     new_pose: torch.Tensor, hessian: torch.Tensor,
                     map_without_matching: bool = False):
    """The gate + map-update half of ``slam_step_jit`` (the JAX package's
    ``update_phase_jit``, hector_slam_tpu/core/slam.py:196-204):
    ``update_phase`` as a CUDA graph on the card. The state is
    DONATED, as in ``slam_step_jit``; the metrics are new tensors."""
    if not graphs.on_card(state.pose):
        return update_phase(state, scan, cfg, new_pose, hessian,
                            map_without_matching)
    return compiled_step(
        "update_phase_jit", (cfg, map_without_matching), state,
        [*scan, new_pose, hessian],
        lambda st, points, origo, mask, pose, hess, in_place:
        update_phase(st, Scan(points, origo, mask), cfg, pose, hess,
                     map_without_matching, in_place=in_place))


def run_log_jit(state: SlamState, scans: Scan, cfg: SlamConfig):
    """Sequential replay with no host round trip per scan (the JAX
    package's ``run_log_jit``, hector_slam_tpu/core/slam.py:207-225): on
    the card one CUDA graph of a ``slam_step`` step, captured
    once per (``cfg``, log shape), reads scan t at a step counter kept on
    the device, writes pose and metrics into slot t of [T] buffers and
    advances the counter; the log is replayed as T graph launches and
    read nowhere on the host. The state is not donated (JAX's is not):
    the graph steps its own copy. Returns what ``run_log`` returns,
    bit-equal to it, the empty log included. On CPU tensors the body runs
    eagerly."""
    n_scans = scans.points.shape[0]
    if not graphs.on_card(state.pose) or n_scans == 0:
        return _replay(state, scans,
                       lambda st, sc: slam_step(st, sc, cfg))
    maps, small = state_leaves(state)
    dev = state.pose.device
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    # slot t of each: the pose and the five metrics after scan t
    outs = [torch.empty((n_scans, *shape), dtype=dtype, device=dev)
            for shape, dtype in (((3,), torch.float32), ((3,), torch.float32),
                                 ((), torch.bool), ((), torch.float32),
                                 ((), torch.int32), ((), torch.int32))]
    n_maps = len(maps)
    n_in = n_maps + 5

    def body(held, statics, write):
        st = state_from_leaves(statics[:n_maps], statics[n_maps:n_in])
        points, origo, mask, t = statics[n_in:n_in + 4]
        at = t.reshape(1)
        new, metrics = slam_step(st, Scan(
            *(x.index_select(0, at)[0] for x in (points, origo, mask))),
            cfg, in_place=write)
        if write:
            _donate(st, new, True)
            for out, x in zip(statics[n_in + 4:], (new.pose, *metrics)):
                out.index_copy_(0, at, x[None])
            t.add_(1)

    with graphs.use("run_log_jit"):
        graph = graphs.entry("run_log_jit", (cfg,), [],
                             maps + small + list(scans) + [counter] + outs,
                             body)
        for _ in range(n_scans):
            graph.replay()
        final = graphs.fresh(state_from_leaves(graph.statics[:n_maps],
                                               graph.statics[n_maps:n_in]))
        poses, *metrics = graphs.fresh(tuple(graph.statics[n_in + 4:]))
    return final, poses, StepMetrics(*metrics)
