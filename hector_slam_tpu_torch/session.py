"""SlamSession: the host-side front end — the L5 layer of the reference
(HectorMappingRos, src/HectorMappingRos.cpp) without ROS: scan
ingestion, start-estimate selection, pause/reset/initial-pose controls,
pose + map products via callbacks, trajectory recording, timing stats,
and batched kidnap and global relocalization.

Counterpart of ``hector_slam_tpu/session.py``, on one device chosen at
construction (the card unless the caller asks for the CPU). Control
parity:
  - ``pause``/``resume``   <- pause_mapping service (:621-627)
  - ``reset``              <- syscommand "reset" (:393-400)
  - ``reset_with_pose``    <- restart_mapping_with_new_pose / reset_map
                              services (:402-433) and initialpose topic
  - ``set_initial_pose``   <- initialpose: applied to the NEXT scan only
                              (:285-292, initial_pose_set_ latch)
  - ``map_with_known_poses`` mode <- :318-321
  - timing stats           <- output_timing (:329-333)
  - map publication gating by update index <- publishMap (:440)

Host-side choices (the hypothesis sampler, the free-cell draw, the
winner's ``np.argmin``) stay in numpy as in JAX, so that both packages
draw the same hypotheses from the same seed and state.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import tracing
from .config import SlamConfig
from .core.grid import map_to_world
from .core.pose2d import compose, invert
from .core.slam import (init_state, match_phase_jit, slam_step_jit,
                        update_phase_jit)
from .export.geotiff import write_geotiff
from .export.occupancy import grid_meta, to_occupancy_grid
from .export.pose_output import pose_stamped
from .export.trajectory import TrajectoryRecorder
from .io.scanlog import LaserModel, scan_from_points, scan_from_ranges
from .parallel.batch import (match_hypotheses_jit, residual_for_poses,
                             residual_for_poses_jit)
from .parallel.kernel_match import match_hypotheses_kernel_jit
from .parallel.onehot_match import auto_num_buckets, match_hypotheses_mxu_jit
from .parallel.recovery import (auto_prune_top_k, cascade_refine_jit,
                                prune_hypotheses_coarse)
from .types import Scan, SlamState, resolve_device

METHODS = ("pallas", "mxu", "quad")


def _leaves(state: SlamState) -> List[torch.Tensor]:
    return [*state.log_odds, *state.quads, state.pose,
            state.last_map_update_pose, state.covariance, state.step,
            state.map_update_count]


def _write_into(dst: SlamState, src: SlamState) -> bool:
    """Copies every leaf of ``src`` into the same leaf of ``dst`` (from any
    device). Returns False, writing nothing, when the two differ in
    structure, shape or dtype, or when two of ``dst``'s leaves share
    memory (a copy into one would change the other)."""
    d, s = _leaves(dst), _leaves(src)
    if len(d) != len(s) or any((a.shape, a.dtype) != (b.shape, b.dtype)
                               for a, b in zip(d, s)):
        return False
    if len({t.untyped_storage().data_ptr() for t in d}) != len(d):
        return False
    for a, b in zip(d, s):
        a.copy_(b)
    return True


class SlamSession:
    """Stateful convenience wrapper around the functional core: holds the
    latest ``SlamState`` on the session's device and the host-side
    bookkeeping; ``slam_step_jit`` does the computation (a CUDA graph
    replay on the card, which updates the state in place)."""

    def __init__(self, cfg: SlamConfig = SlamConfig(),
                 laser: LaserModel = LaserModel(),
                 map_with_known_poses: bool = False,
                 on_pose: Optional[Callable] = None,
                 on_map_update: Optional[Callable] = None,
                 timing_mode: str = "step",
                 geotiff_save_period: float = 0.0,
                 geotiff_base_path: str = "GeoTiffMap",
                 device="cuda"):
        """``timing_mode``: "step" (default) runs each scan through
        ``slam_step_jit``; "phases" runs ``match_phase_jit`` and
        ``update_phase_jit`` with a host barrier between them and records
        per-phase wall times in timing_stats() (SURVEY.md §5), as the JAX
        session does. Both run the same torch ops in the same order, so
        their poses are bit-equal to ``slam_step``'s.

        ``geotiff_save_period`` > 0 enables the periodic geotiff autosave
        of the reference's geotiff node (geotiff_node.cpp:79-86,
        :250-253): every ``period`` seconds of scan-stamp time (wall time
        since the first scan when scans carry no stamps) the map is
        re-rendered to ``geotiff_base_path``.

        ``device``: where every tensor of the session lives; "cuda"
        raises when no card is present."""
        if timing_mode not in ("step", "phases"):
            raise ValueError(f"unknown timing_mode {timing_mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.laser = laser
        self.map_with_known_poses = map_with_known_poses
        self.on_pose = on_pose
        self.on_map_update = on_map_update
        self.timing_mode = timing_mode
        self.trajectory = TrajectoryRecorder()
        self.state: SlamState = init_state(cfg, self.device)
        self.paused = False
        self._initial_pose: Optional[np.ndarray] = None
        self._last_odom: Optional[np.ndarray] = None
        self._last_scan: Optional[Scan] = None
        self._last_stamp: float = 0.0
        self._scan_times_ms: List[float] = []
        self._match_times_ms: List[float] = []
        self._update_times_ms: List[float] = []
        self._published_update_count = -1
        self.geotiff_save_period = float(geotiff_save_period)
        self.geotiff_base_path = geotiff_base_path
        self._next_geotiff_stamp: Optional[float] = None
        self._geotiff_wall_t0: Optional[float] = None
        self.meta = grid_meta(cfg.map)

    # ---- controls ----------------------------------------------------------

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def reset(self) -> None:
        """Full reset: fresh maps, zero pose (syscommand "reset"). The
        fresh values are written into the state's own tensors, so the
        step graph keyed on the maps' memory is replayed on the next scan,
        not captured again, as the JAX session reuses its compiled step.
        Like a donating step, this overwrites the maps of any state that
        shares them (clone a state you keep with ``graphs.fresh``). The
        fresh values are made on the host and copied in, so a reset takes
        no device memory (its values are exact: 0, 0.5, FLT_MAX)."""
        if not _write_into(self.state, init_state(self.cfg, "cpu")):
            self.state = init_state(self.cfg, self.device)
        self.trajectory.reset()
        self._scan_times_ms.clear()
        self._match_times_ms.clear()
        self._update_times_ms.clear()
        self._published_update_count = -1
        # a pre-reset odometry latch must not propagate a stale delta
        # into the fresh trajectory; the geotiff timer re-arms too
        self._last_odom = None
        self._next_geotiff_stamp = None
        self._geotiff_wall_t0 = None

    def reset_with_pose(self, pose) -> None:
        """restart_mapping_with_new_pose: reset maps AND seed the pose."""
        self.reset()
        self.set_initial_pose(pose)

    def set_initial_pose(self, pose) -> None:
        """Latched like initial_pose_set_: consumed by the next scan.
        theta is wrapped to [-pi, pi] on entry, as tf::getYaw of the
        reference's initialpose quaternion is (HectorMappingRos.cpp:
        621-627)."""
        p = np.asarray(pose, np.float32).copy()
        p[2] = np.float32(np.arctan2(np.sin(np.float64(p[2])),
                                     np.cos(np.float64(p[2]))))
        self._initial_pose = p

    def pose_hint_from_odom(self, odom_pose) -> Optional[np.ndarray]:
        """Odometry-propagated start estimate (use_tf_pose_start_estimate,
        HectorMappingRos.cpp:291-309): the last scan-match pose advanced
        by the odometry delta since that scan,

            hint = slam_pose o (last_odom^-1 o current_odom).

        The first call (no previous odometry) returns None, and the
        caller falls back to the last scan-match pose (:304-308). The
        odom pose is latched here."""
        odom = np.asarray(odom_pose, np.float64)
        prev = self._last_odom
        self._last_odom = odom
        if prev is None:
            return None
        delta = compose(invert(prev), odom)
        hint = compose(self.pose.astype(np.float64), delta)
        return np.asarray(hint, np.float32)

    # ---- scan processing ---------------------------------------------------

    def process_ranges(self, ranges, stamp: float = 0.0,
                       pose_hint=None, odom_pose=None
                       ) -> Optional[np.ndarray]:
        """Polar scan path (rosLaserScanToDataContainer)."""
        with tracing.Timer("session.scan", "hs.scan"):
            with tracing.Timer("session.convert", "hs.convert") as conv:
                scan = scan_from_ranges(np.asarray(ranges, np.float32),
                                        self.cfg.map.level_scale(0),
                                        self.laser, self.cfg.max_beams,
                                        device=self.device)
            return self._process(scan, conv.t1, stamp, pose_hint,
                                 odom_pose)

    def process_points(self, points_base, stamp: float = 0.0,
                       pose_hint=None, origo=(0.0, 0.0),
                       z_min: float = -1.0, z_max: float = 1.0,
                       min_dist: float = 0.4, max_dist: float = 30.0,
                       odom_pose=None) -> Optional[np.ndarray]:
        """Cartesian point path (rosPointCloudToDataContainer,
        HectorMappingRos.cpp:509-542) with the reference's three filters:
        the squared-range window (:96-102,526), the behind-robot cull
        (x<0 points closer than sqrt(0.5) m, :528-530), and the z-band
        for 3D input (:534-539)."""
        with tracing.Timer("session.scan", "hs.scan"):
            with tracing.Timer("session.convert", "hs.convert") as conv:
                pts = np.asarray(points_base, np.float32)
                dist_sqr = pts[:, 0] ** 2 + pts[:, 1] ** 2
                keep = (dist_sqr > np.float32(min_dist) ** 2) \
                    & (dist_sqr < np.float32(max_dist) ** 2) \
                    & ~((pts[:, 0] < 0.0) & (dist_sqr < np.float32(0.5)))
                pts = pts[keep]
                if pts.shape[1] == 3:
                    keep = (pts[:, 2] > z_min) & (pts[:, 2] < z_max)
                    pts = pts[keep, :2]
                scan = scan_from_points(pts, self.cfg.map.level_scale(0),
                                        self.cfg.max_beams, origo,
                                        device=self.device)
            return self._process(scan, conv.t1, stamp, pose_hint,
                                 odom_pose)

    def _hint(self, pose_hint, odom_pose) -> Optional[torch.Tensor]:
        """Start estimate selection (:285-315): an explicit pose_hint
        beats the latched initial pose, which beats the odom-propagated
        estimate; None means the last scan-match pose."""
        odom_hint = (self.pose_hint_from_odom(odom_pose)
                     if odom_pose is not None else None)
        if pose_hint is not None:
            hint = np.asarray(pose_hint, np.float32)
        elif self._initial_pose is not None:
            hint, self._initial_pose = self._initial_pose, None
        elif odom_hint is not None:
            hint = odom_hint
        else:
            return None
        return torch.tensor(hint, dtype=torch.float32, device=self.device)

    def process_scan(self, scan: Scan, stamp: float = 0.0,
                     pose_hint=None, odom_pose=None
                     ) -> Optional[np.ndarray]:
        """One scan through the engine. Returns the new world pose, or
        None while paused (scanCallback pause gate, :237-240).

        ``odom_pose``: the robot's wheel-odometry pose at this scan's
        stamp; enables the odometry-propagated start estimate
        (``pose_hint_from_odom``)."""
        with tracing.Timer("session.scan", "hs.scan") as root:
            return self._process(scan, root.t0, stamp, pose_hint, odom_pose)

    def _process(self, scan: Scan, t0: int, stamp, pose_hint, odom_pose
                 ) -> Optional[np.ndarray]:
        """``process_scan`` inside its ``hs.scan`` span; ``t0``: the clock
        reading (``perf_counter_ns``) the scan's own time runs from."""
        if self.paused:
            return None
        hint = self._hint(pose_hint, odom_pose)
        known = self.map_with_known_poses
        if self.timing_mode == "phases":
            new_pose, hessian = match_phase_jit(self.state, scan, self.cfg,
                                                hint, known)
            new_pose.cpu()   # completion barrier for the phase
            t1 = time.perf_counter_ns()
            self.state, metrics = update_phase_jit(
                self.state, scan, self.cfg, new_pose, hessian, known)
        else:
            self.state, metrics = slam_step_jit(self.state, scan, self.cfg,
                                                hint, known)
        # pose, covariance and gate in one device->host copy
        with tracing.Timer("session.read", "hs.read") as read:
            host = torch.cat([self.state.pose,
                              self.state.covariance.reshape(9),
                              metrics.map_updated.to(torch.float32)
                              .reshape(1)]).cpu().numpy()
        t2 = read.t1
        if self.timing_mode == "phases":
            self._match_times_ms.append((t1 - t0) * 1e-6)
            self._update_times_ms.append((t2 - t1) * 1e-6)
        self._scan_times_ms.append((t2 - t0) * 1e-6)
        if host[12] != 0.0:
            tracing.count("update.gated")
        pose = host[:3].copy()

        self._last_scan = scan
        self._last_stamp = float(stamp)
        self.trajectory.add(stamp, pose)
        if self.on_pose is not None:
            self.on_pose(pose_stamped(pose, host[3:12].reshape(3, 3), stamp))
        if self.on_map_update is not None and host[12] != 0.0:
            self.on_map_update(self)
        if self.geotiff_save_period > 0.0:
            self._geotiff_tick(stamp)
        return pose

    def _geotiff_tick(self, stamp: float) -> None:
        """The autosave timer: scan-stamp time whenever scans carry
        nonzero stamps (deterministic for log replay), wall time since
        the first scan for an unstamped live feed (the reference node's
        wall-clock timer, geotiff_node.cpp:79-86). The first save comes
        one period after the first scan."""
        if self._geotiff_wall_t0 is None:
            self._geotiff_wall_t0 = time.perf_counter()
        if float(stamp) > 0.0:
            clock = float(stamp)
        else:
            clock = time.perf_counter() - self._geotiff_wall_t0
        if self._next_geotiff_stamp is None:
            self._next_geotiff_stamp = clock + self.geotiff_save_period
        elif clock >= self._next_geotiff_stamp:
            self.save_geotiff(self.geotiff_base_path)
            self._next_geotiff_stamp = clock + self.geotiff_save_period

    # ---- recovery ----------------------------------------------------------

    def _scan_and_method(self, scan, method, use_pallas):
        if scan is None:
            scan = self._last_scan
        if scan is None:
            raise ValueError("no scan to relocalize against — process one "
                             "first or pass scan=")
        if method is None:
            if use_pallas is None:
                use_pallas = self.device.type == "cuda"
            method = "pallas" if use_pallas else "quad"
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        return scan, method

    def relocalize(self, scan: Optional[Scan] = None,
                   n_hypotheses: int = 1024,
                   sigma_xy: float = 0.5, sigma_theta: float = 0.3,
                   seed: int = 0,
                   use_pallas: Optional[bool] = None,
                   method: Optional[str] = None,
                   pallas_interpret: bool = False,
                   theta_stratified: Optional[bool] = None,
                   k_budget: int = 8192,
                   prune_top_k: Optional[int] = None) -> dict:
        """Batched recovery: spawns ``n_hypotheses`` start poses around
        the current pose (hypothesis 0 IS the current pose), GN-matches
        all of them against the current map pyramid (the SlamState.quads
        epoch cache), scores them by finest-level residual
        (getResidualForState, OccGridMapUtil.h:204-221), and re-seeds the
        session pose with the winner. ``scan`` defaults to the last
        processed scan.

        ``method`` keeps the JAX package's names, each run through a
        compiled entry point as the JAX session runs it (a CUDA graph on
        the card, kept for the session's maps; eager on the CPU):
          - "pallas": ``match_hypotheses_kernel_jit`` (the moments kernel),
            through ``cascade_refine_jit`` when the batch was pruned;
          - "mxu":    ``match_hypotheses_mxu_jit`` (the theta-bucketed
            patch matcher, its bucket count from the hypotheses' theta
            spread by ``auto_num_buckets``, JAX's default repair budget)
            on the whole batch, no cascade;
          - "quad":   ``match_hypotheses_jit``, the torch-op matcher;
          - None:     "pallas" on the card, "quad" on the CPU.
        ``use_pallas`` (bool) is the legacy spelling of "pallas"/"quad".
        The pruning, the finest-level scoring and the acceptance stay
        eager, as in the JAX session.

        ``pallas_interpret`` and ``k_budget`` are the JAX session's: there
        they run the TPU kernel in interpret mode and size the repair
        budget of its VMEM windows. The card's moments kernel has no
        windows, so on the port they change no result; "mxu" uses its own
        default budget, as in JAX.

        ``theta_stratified`` (default: on for n >= 128) samples theta on
        a grid of n/128 values over +-2 sigma_theta, one per 128
        hypotheses, instead of iid Gaussian. ``prune_top_k`` (default:
        ``auto_prune_top_k``; 0 disables) first keeps the best groups by
        coarsest-level residual; the incumbent always survives.

        Returns {"pose", "residual", "accepted", "improvement",
        "fast_path_fraction", "overflow_steps"}. ``accepted`` is False
        (pose and covariance untouched) unless some challenger strictly
        beats the GN-refined incumbent's residual.
        ``fast_path_fraction`` and ``overflow_steps`` are the matcher's
        telemetry: 1.0 and 0 through the moments kernel (no query leaves
        it), the patch matcher's for "mxu", None and 0 for "quad"."""
        scan, method = self._scan_and_method(scan, method, use_pallas)
        rng = np.random.default_rng(seed)
        base = self.pose
        if theta_stratified is None:
            theta_stratified = n_hypotheses >= 128
        if theta_stratified:
            g = max(1, int(round(n_hypotheses / 128)))
            sizes = np.full(g, n_hypotheses // g, np.int64)
            sizes[:n_hypotheses % g] += 1
            thetas = base[2] + sigma_theta * (
                -2.0 + 4.0 * (np.arange(g) + 0.5) / g)
            hyp = np.c_[base[0] + rng.normal(0, sigma_xy, n_hypotheses),
                        base[1] + rng.normal(0, sigma_xy, n_hypotheses),
                        np.repeat(thetas, sizes)].astype(np.float32)
        else:
            hyp = base + np.c_[rng.normal(0, sigma_xy, (n_hypotheses, 2)),
                               rng.normal(0, sigma_theta, n_hypotheses)
                               ].astype(np.float32)
        hyp[0] = base   # the incumbent always competes
        hyp_t = torch.from_numpy(hyp).to(self.device)

        if prune_top_k is None:
            prune_top_k = auto_prune_top_k(n_hypotheses)
        pruned = bool(prune_top_k) and prune_top_k < n_hypotheses
        if pruned:
            hyp_t = prune_hypotheses_coarse(
                self.state.log_odds, hyp_t, scan, self.cfg, prune_top_k,
                quads=self.state.quads)
        return self._refine_and_accept(hyp_t, scan, method,
                                       use_cascade=pruned)

    def _refine_and_accept(self, hyp: torch.Tensor, scan: Scan, method: str,
                           use_cascade: bool) -> dict:
        """Shared tail of ``relocalize`` / ``relocalize_global``: GN-refine
        the batch through the selected matcher, score on the finest
        level, and re-seed the session iff some challenger strictly beats
        the refined incumbent in slot 0 (the incumbent is the bar, never
        applied). ``use_cascade`` routes "pallas" through
        ``cascade_refine_jit`` (needs >= 2 levels)."""
        st = self.state
        diag = None
        if method == "pallas" and use_cascade and self.cfg.map.levels >= 2:
            result, diag = cascade_refine_jit(st.log_odds, hyp, scan,
                                              self.cfg, quads=st.quads)
        elif method == "pallas":
            result, diag = match_hypotheses_kernel_jit(
                st.log_odds, hyp, scan, self.cfg, quads=st.quads)
        elif method == "mxu":
            result, diag = match_hypotheses_mxu_jit(
                st.log_odds, hyp, scan, self.cfg,
                num_buckets=auto_num_buckets(hyp),
                with_diag=True)
        else:
            result = match_hypotheses_jit(st.log_odds, hyp, scan, self.cfg)
        res = residual_for_poses(st.log_odds[0], result.pose, scan, self.cfg,
                                 quad=st.quads[0] if st.quads else None)
        res = res.cpu().numpy()
        best = int(np.argmin(res))
        # strict improvement only: the incumbent's own (possibly refined)
        # residual is the bar
        accepted = bool(res[best] < res[0])
        out = {
            "pose": result.pose[best].cpu().numpy(),
            "residual": float(res[best]),
            "accepted": accepted,
            "improvement": float(res[0] - res[best]),
            "fast_path_fraction": (None if diag is None
                                   else float(diag.fast_path_fraction())),
            "overflow_steps": 0 if diag is None else int(diag.overflow_steps),
        }
        if accepted:
            self.state = st._replace(pose=result.pose[best],
                                     covariance=result.hessian[best])
        return out

    def relocalize_global(self, scan: Optional[Scan] = None,
                          n_positions: int = 2048, n_theta: int = 32,
                          top_k: int = 1024, seed: int = 0,
                          method: Optional[str] = None,
                          k_budget: int = 8192,
                          pallas_interpret: bool = False,
                          beam_stride: int = 8) -> dict:
        """Global (position-unknown) relocalization over the whole mapped
        free space — the kidnapped-robot problem with no prior; the
        reference's answer is an operator clicking initialpose in rviz
        (HectorMappingRos.cpp:621-627).

        1. Sweep: ``n_positions`` positions drawn without replacement
           from the coarsest level's known-free cells (every free cell,
           repeated to ``n_positions``, when there are fewer) x
           ``n_theta`` headings uniform over [-pi, pi), scored by the
           coarsest level's residual with a ``beam_stride``-subsampled
           scan through ``residual_for_poses_jit``. One residual pass, no
           GN; on the card its graph keeps the pass's temporaries (~1 GB
           at the defaults) in its pool while it is cached.
        2. Refine: the incumbent and the ``top_k - 1`` best sweep entries,
           sorted by heading, through ``_refine_and_accept`` with the
           cascade — ``relocalize``'s acceptance bar.

        ``k_budget`` and ``pallas_interpret``: as in ``relocalize``, JAX's
        TPU-window options, which change no result on the port.

        Returns the ``relocalize`` dict plus ``n_free_cells`` and
        ``sweep_best_residual``."""
        scan, method = self._scan_and_method(scan, method, None)
        coarse = self.cfg.map.levels - 1
        occ = to_occupancy_grid(self.state.log_odds[coarse],
                                self.cfg.update.cell_model)
        free_yx = np.argwhere(occ == 0)
        n_free = len(free_yx)
        if n_free == 0:
            raise ValueError("no known-free cells to sample (empty map)")

        rng = np.random.default_rng(seed)
        if n_free <= n_positions:
            sel = free_yx[np.resize(np.arange(n_free), n_positions)]
        else:
            sel = free_yx[rng.choice(n_free, n_positions, replace=False)]
        centers_map = np.c_[sel[:, 1], sel[:, 0]].astype(np.float32) + 0.5
        centers = map_to_world(torch.from_numpy(centers_map),
                               self.cfg.map.top_left_offset,
                               self.cfg.map.level_resolution(coarse)).numpy()

        # theta-major layout: all positions of one heading are contiguous
        thetas = (-np.pi + 2.0 * np.pi * (np.arange(n_theta) + 0.5)
                  / n_theta).astype(np.float32)
        sweep = np.empty((n_theta * n_positions, 3), np.float32)
        sweep[:, :2] = np.tile(centers, (n_theta, 1))
        sweep[:, 2] = np.repeat(thetas, n_positions)

        sub = Scan(points=scan.points[::beam_stride], origo=scan.origo,
                   mask=scan.mask[::beam_stride])
        quads = self.state.quads
        res_sweep = residual_for_poses_jit(
            self.state.log_odds[coarse],
            torch.from_numpy(sweep).to(self.device), sub, self.cfg,
            quad=quads[coarse] if len(quads) > coarse else None,
            level=coarse).cpu().numpy()

        # refine batch = incumbent + (top_k - 1) sweep survivors, sorted
        # by heading (a multiple of 128 at the default 1024, so the
        # cascade keeps whole groups)
        top_k = min(top_k, len(sweep))
        n_surv = top_k - 1
        order = np.argpartition(res_sweep, n_surv)[:n_surv]
        surv = sweep[order]
        surv = surv[np.argsort(surv[:, 2], kind="stable")]
        hyp = np.concatenate([self.pose[None], surv], axis=0)
        out = self._refine_and_accept(torch.from_numpy(hyp).to(self.device),
                                      scan, method, use_cascade=True)
        out["n_free_cells"] = int(n_free)
        out["sweep_best_residual"] = float(res_sweep.min())
        return out

    # ---- products ----------------------------------------------------------

    @property
    def pose(self) -> np.ndarray:
        return self.state.pose.cpu().numpy()

    @property
    def covariance(self) -> np.ndarray:
        """Raw scan-match Hessian (the reference's covariance output)."""
        return self.state.covariance.cpu().numpy()

    def slam_cloud(self, frame: str = "map") -> np.ndarray:
        """The last processed scan as a Cartesian point cloud — the
        node's ``slam_cloud`` product (HectorMappingRos.cpp:193,276-278).
        ``frame="base"``: points in meters in the sensor frame, as the
        reference publishes them; ``frame="map"`` (default): transformed
        by the matched pose. Returns f32[N, 2] (valid beams only)."""
        if self._last_scan is None:
            raise ValueError("no scan processed yet")
        sc = self._last_scan
        pts = sc.points.cpu().numpy()
        keep = sc.mask.cpu().numpy()
        pts = pts[keep] / np.float32(self.cfg.map.level_scale(0))
        if frame == "base":
            return pts
        if frame != "map":
            raise ValueError(f"unknown frame {frame!r}")
        pose = self.pose.astype(np.float64)
        c, s = np.cos(pose[2]), np.sin(pose[2])
        out = np.empty_like(pts)
        out[:, 0] = pose[0] + c * pts[:, 0] - s * pts[:, 1]
        out[:, 1] = pose[1] + s * pts[:, 0] + c * pts[:, 1]
        return out

    def scanmatch_odom(self) -> dict:
        """Odometry-shaped output of the scan matcher — the node's
        ``scanmatch_odom`` publication (HectorMappingRos.cpp:93,124,
        351-356): the pose with covariance of the last match in the map
        frame, base frame as child, twist zero as the reference leaves
        it."""
        msg = pose_stamped(self.pose, self.covariance, self._last_stamp)
        msg["frame_id"] = "map"
        msg["child_frame_id"] = "base_link"
        msg["twist"] = np.zeros(6, np.float64)
        return msg

    def occupancy_grid(self, level: int = 0,
                       only_if_changed: bool = False
                       ) -> Optional[np.ndarray]:
        """int8 map export; with only_if_changed, None is returned when
        the map has not been updated since the last export (publishMap's
        update-index gate, :440)."""
        count = int(self.state.map_update_count)
        if only_if_changed and count == self._published_update_count:
            return None
        self._published_update_count = count
        return to_occupancy_grid(self.state.log_odds[level],
                                 self.cfg.update.cell_model)

    def save_geotiff(self, base_path: str, with_trajectory: bool = True,
                     objects=(), draw_fns=()) -> tuple:
        """syscommand "savegeotiff" (geotiff_node.cpp:255-262): renders
        the level-0 map (+ recorded trajectory + objects of interest) to
        <base>.png + <base>.tfw. ``draw_fns`` are writer plugins
        (map_writer_plugin_interface.h:36-43). Renders from the state, not
        through occupancy_grid's update-index gate (geotiff_node.cpp:126)."""
        occ = to_occupancy_grid(self.state.log_odds[0],
                                self.cfg.update.cell_model)
        path = self.trajectory.path() if with_trajectory else None
        if path is not None and not len(path):
            path = None
        return write_geotiff(occ, self.meta, base_path, path_world=path,
                             objects=objects, draw_fns=draw_fns)

    def timing_stats(self) -> dict:
        """output_timing equivalent, aggregated; with
        timing_mode="phases", adds per-phase match/update wall times."""
        if not self._scan_times_ms:
            return {"count": 0}
        a = np.asarray(self._scan_times_ms)
        out = {"count": len(a), "p50_ms": float(np.percentile(a, 50)),
               "p95_ms": float(np.percentile(a, 95)),
               "mean_ms": float(a.mean())}
        if self._match_times_ms:
            m = np.asarray(self._match_times_ms)
            u = np.asarray(self._update_times_ms)
            out["match_p50_ms"] = float(np.percentile(m, 50))
            out["match_mean_ms"] = float(m.mean())
            out["update_p50_ms"] = float(np.percentile(u, 50))
            out["update_mean_ms"] = float(u.mean())
        return out

    def profile_trace(self, log_dir: str):
        """A ``torch.profiler.profile`` context (SURVEY.md §5) that writes
        a trace of everything run inside to ``log_dir`` (Chrome trace
        JSON, readable by TensorBoard's profiler plugin), the card's
        kernels included when the session is on it, and the port's spans
        (``tracing``: each scan's ``hs.scan`` with its conversion, graph
        use and read):

            with session.profile_trace("slam_trace"):
                for r in ranges: session.process_ranges(r)
        """
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
