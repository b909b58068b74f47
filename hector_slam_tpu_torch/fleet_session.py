"""FleetSession: the host-side front end of a fleet of robots served
together on one device, each a ``hector_mapping`` node with its own map
pyramid, as ``SlamSession`` is for one robot.

A fleet server takes every robot's newest scan at each tick. One tick is
one batched conversion of the R robots' ranges to a ``Scan`` on the
device (``io/scanlog.scans_from_ranges``, bit-equal per robot to
``scan_from_ranges``), one ``fleet_step_jit`` (a CUDA graph replay on the
card, which updates the fleet's state in place), and one device->host copy
of the R poses and gates. Each robot's start estimate is its last pose,
the node's default, as in ``SlamSession`` without a hint; each robot's
poses, gates and maps are bit-equal to its own ``SlamSession``'s.

With ``shared_map=True`` the R robots map one building into ONE map
pyramid (``parallel/shared_map.py``): the tick's step is one
``shared_fleet_step_jit`` replay, which matches every robot against the
shared map and writes the union of the gated robots' cell sets into it
once, only when some robot's gate fired. Each robot starts at its own
pose in the map's frame (``start_poses``), as a multi-robot system is
told where its robots start.

Spans and counters (``tracing``): ``hs.fleet`` (timer ``fleet.step``)
around a tick, holding ``hs.fleet.convert`` (``fleet.convert``), the
graph's ``hs.graph:fleet_step_jit`` (``hs.graph:shared_fleet_step_jit``
with a shared map) and ``hs.fleet.read`` (``fleet.read``);
``fleet.robot_steps`` counts R a tick and ``fleet.gated`` the robots
whose gate the read brought back set; with a shared map
``fleet.map_writes`` counts the ticks that wrote it.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import tracing
from .config import SlamConfig
from .io.scanlog import LaserModel, beam_directions, scans_from_ranges
from .parallel.batch import fleet_step_jit, init_fleet
from .parallel.shared_map import init_shared_fleet, shared_fleet_step_jit
from .types import SlamState, resolve_device


class FleetSession:
    """Holds a fleet's stacked ``SlamState`` (a leading robot axis on
    every leaf; with a shared map, on every leaf but the maps) on the
    session's device, the last tick's gates and the ticks' host times;
    ``fleet_step_jit`` (``shared_fleet_step_jit``) does the computation."""

    def __init__(self, cfg: SlamConfig = SlamConfig(),
                 laser: LaserModel = LaserModel(), robots: int = 1,
                 device="cuda", *, shared_map: bool = False,
                 start_poses=None):
        """``robots``: the fleet's size R, fixed for the session.
        ``device``: where every tensor of the session lives; "cuda"
        raises when no card is present. ``shared_map``: the R robots map
        into one shared pyramid instead of one each. ``start_poses``
        f32[R, 3]: with a shared map, each robot's start in the map's
        world frame (zeros if not given); a robot with a map of its own
        starts at its map's origin."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.laser = laser
        self.robots = int(robots)
        self.shared_map = bool(shared_map)
        if self.shared_map:
            self.state: SlamState = init_shared_fleet(
                cfg, self.robots, start_poses, self.device)
        elif start_poses is not None:
            raise ValueError("start_poses needs shared_map=True: a robot "
                             "with a map of its own starts at its origin")
        else:
            self.state = init_fleet(cfg, self.robots, self.device)
        self.gates = np.zeros(self.robots, np.bool_)
        # whether the last tick wrote the shared map (some gate fired)
        self.map_written = False
        self._directions = beam_directions(laser, laser.num_beams,
                                           self.device)
        self._step_times_ms: List[float] = []

    def process_ranges(self, ranges) -> np.ndarray:
        """One tick: ranges f32[R, B] (robot r's newest scan in row r) in,
        the R new world poses f32[R, 3] out; ``gates`` then holds which
        robots' maps this tick updated (with a shared map: which robots'
        scans this tick painted into it), and ``map_written`` whether
        the shared map was written."""
        with tracing.Timer("fleet.step", "hs.fleet"):
            with tracing.Timer("fleet.convert", "hs.fleet.convert") as conv:
                r = np.ascontiguousarray(ranges, np.float32)
                if r.ndim != 2 or r.shape[0] != self.robots \
                        or r.shape[1] > self.laser.num_beams:
                    raise ValueError(
                        f"ranges of shape {r.shape}: expected [{self.robots}"
                        f", at most {self.laser.num_beams} beams]")
                scans = scans_from_ranges(
                    torch.from_numpy(r).to(self.device),
                    self._directions[:r.shape[1]],
                    self.cfg.map.level_scale(0), self.laser,
                    self.cfg.max_beams)
            step = shared_fleet_step_jit if self.shared_map \
                else fleet_step_jit
            self.state, metrics = step(self.state, scans, self.cfg)
            # poses and gates in one device->host copy
            with tracing.Timer("fleet.read", "hs.fleet.read") as read:
                host = torch.cat([self.state.pose.reshape(-1),
                                  metrics.map_updated.to(torch.float32)]
                                 ).cpu().numpy()
        self._step_times_ms.append((read.t1 - conv.t1) * 1e-6)
        n = 3 * self.robots
        self.gates = host[n:] != 0.0
        tracing.count("fleet.robot_steps", self.robots)
        tracing.count("fleet.gated", int(self.gates.sum()))
        if self.shared_map:
            # the step writes the shared map exactly when its any-gate,
            # the OR of these R gates, is set
            self.map_written = bool(self.gates.any())
            tracing.count("fleet.map_writes", int(self.map_written))
        return host[:n].reshape(self.robots, 3).copy()

    def timing_stats(self) -> dict:
        """``SlamSession.timing_stats`` of the ticks: each tick's host
        time from its conversion's end to its poses on the host."""
        if not self._step_times_ms:
            return {"count": 0}
        a = np.asarray(self._step_times_ms)
        return {"count": len(a), "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "mean_ms": float(a.mean())}
