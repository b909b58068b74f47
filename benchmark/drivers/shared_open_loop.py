"""A fleet of robots mapping ONE building into ONE shared map, served
together through ``FleetSession(..., shared_map=True).process_ranges``,
open loop at the sensors' rate.

Set-up: the seed's laps (every robot in the one world, each from its own
start on the loop, in the map's frame; ``sim/shared.py``), the fleet
session with each robot's true start, and a warm-up lap of ticks back to
back through the session (it captures the shared step's graph and builds
the map the window starts on). Window: ``rate_hz * seconds`` ticks, tick
k due at t0 + k / rate_hz whether or not tick k-1 has finished, every
robot's newest scan in each; a robot-scan's time runs from its tick's
due time to all R poses in host memory, as in the per-robot fleet's
cell. The laps go on where the warm-up left them. Judged: every robot's
every pose and gate, warm-up included, and the shared map at the end,
along the program's own path (``reference/shared_ref.py``).
"""

from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from ..reference import shared_ref, slam_ref
from ..roofline import raster_paint as rp
from ..sim import shared
from . import common
from .session_open_loop import reference_scans


def reference_scan_at(cell, laps, dev):
    """``scan_at(t)`` -> tick t's (points [R, N, 2], origo [R, 2], mask
    [R, N]) of every robot, the reference's own conversion in finest-level
    map units."""
    n_lap = laps.ranges.shape[1]
    pts, keep = reference_scans(cell.config, laps.ranges, dev)
    origo = torch.zeros((pts.shape[0], 2), dtype=torch.float64, device=dev)

    def scan_at(t):
        return pts[:, t % n_lap], origo, keep[:, t % n_lap]
    return scan_at


def judge_run(run, laps, poses, gated, maps, scan_at):
    """(numbers, the control's numbers or None) of the shared fleet's
    path: poses f32[T, R, 3], gates bool[T, R], the shared levels."""
    dev = torch.device(run.device)
    p = slam_ref.params(run.cell.config)
    path = torch.from_numpy(poses)
    starts = torch.from_numpy(laps.starts)
    nums = shared_ref.judge_shared(p, path, starts, torch.from_numpy(gated),
                                   maps, scan_at, dev)
    control = None
    if run.info.get("with_control"):
        control = shared_ref.control_shared(p, path, starts, scan_at, dev)
    return nums, control


def paint_bytes(cell, ticks, poses, gated, scan_at):
    """The least bytes of each of these ticks' paint launches
    (``roofline/raster_paint.tick_bytes``) at the program's poses f32[T,
    R, 3] and gates bool[T, R]."""
    p = slam_ref.params(cell.config)
    out = []
    for i in ticks:
        pts, origo, mask = scan_at(i)
        out.append(rp.tick_bytes(p, int(cell.config["max_beams"]),
                                 torch.from_numpy(poses[i]),
                                 torch.from_numpy(gated[i]), pts, origo,
                                 mask))
    return out


def main(run) -> None:
    import hector_slam_tpu_torch as hs
    from hector_slam_tpu_torch import FleetSession
    from hector_slam_tpu_torch.core import graphs
    # a program whose fleet front end has no shared map stops here,
    # before any work
    if "shared_map" not in inspect.signature(FleetSession).parameters:
        raise RuntimeError("FleetSession has no shared-map mode")

    cell, tr = run.cell, run.cell.traffic
    dev = torch.device(run.device)
    cfg = common.slam_config(hs, cell.config)
    rate = float(cell.config["laser"]["rate_hz"])
    robots = int(cell.config["robots"])
    laps = shared.make_shared_laps(tr, cell.config["laser"], robots,
                                   run.seed, dev)
    # [L, R, B]: tick i takes row i mod L, every robot's scan of it
    ticks = np.ascontiguousarray(
        laps.ranges.cpu().numpy().transpose(1, 0, 2))
    n_lap = ticks.shape[0]
    n_warm = tr["warmup_laps"] * n_lap
    n_win = int(round(run.seconds * rate))
    total = n_warm + n_win
    poses = np.zeros((total, robots, 3), np.float32)
    gated = np.zeros((total, robots), bool)
    written = np.zeros(total, bool)

    fleet = FleetSession(cfg, common.laser_model(hs, cell.config), robots,
                         device=dev, shared_map=True,
                         start_poses=laps.starts)
    for i in range(n_warm):
        poses[i] = fleet.process_ranges(ticks[i % n_lap])
        gated[i] = fleet.gates
        written[i] = fleet.map_written
    run.tracer.warm()
    traced = range(min(tr["traced_from"], n_win),
                   min(tr["traced_from"] + tr["traced_scans"], n_win))
    latency = np.empty(n_win)
    started_late = np.empty(n_win)
    run.setup_done()

    t0 = time.perf_counter() + 0.01
    end = t0
    for k in range(n_win):
        if k == traced.start:
            run.tracer.start()
        if k == traced.stop:
            run.tracer.stop()
        i = n_warm + k
        due = t0 + k / rate
        with run.tracer.span("traffic.wait_due"):
            common.wait_until(due)
        begin = time.perf_counter()
        with run.tracer.span("fleet.process_ranges"):
            poses[i] = fleet.process_ranges(ticks[i % n_lap])
        end = time.perf_counter()
        gated[i] = fleet.gates
        written[i] = fleet.map_written
        latency[k] = end - due
        started_late[k] = begin - due
    run.tracer.stop()
    window_s = end - t0

    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    pools = [g.pool_bytes for g in graphs.stats()
             if g.name == "shared_fleet_step_jit"]
    run.info["graph_pool_bytes"] = pools[-1] if pools else 0
    run.info["traced_steps"] = len(traced)
    run.info["traced_started_late_s"] = started_late[traced.start:
                                                     traced.stop].tolist()
    run.attempted = n_win * robots
    run.failed = common.non_finite(poses[n_warm:].reshape(-1, 3))
    per_scan = np.repeat(latency, robots)
    run.e2e["scan_p95_ms"] = float(np.percentile(per_scan, 95) * 1e3)
    late = float((latency > 1.0 / rate).mean() * 100.0)
    run.note(f"window {window_s:.3f} s for {n_win} ticks of {robots} robots "
             f"on one map at {rate} Hz; robot-scan p50 "
             f"{np.percentile(per_scan, 50) * 1e3:.3f} ms p95 "
             f"{run.e2e['scan_p95_ms']:.3f} ms max {latency.max() * 1e3:.3f}"
             f" ms; ticks past one period {late:.2f}%; gated "
             f"{gated[n_warm:].mean() * 100:.2f}% of the window's "
             f"robot-scans; map written on {written[n_warm:].mean() * 100:.2f}"
             f"% of its ticks; peak {run.memory_peak_bytes} B, graph pool "
             f"{run.info['graph_pool_bytes']} B")

    maps = [lo.clone() for lo in fleet.state.log_odds]
    del fleet
    common.free_program(dev)
    t_ref = time.perf_counter()
    scan_at = reference_scan_at(cell, laps, dev)
    nums, control = judge_run(run, laps, poses, gated, maps, scan_at)
    run.note(f"reference: {total} ticks of {robots} robots on one map "
             f"judged in {time.perf_counter() - t_ref:.2f} s; "
             f"{nums.pop('log')}")
    if run.traced:
        run.info["raster_paint_bytes"] = paint_bytes(
            cell, range(n_warm + traced.start, n_warm + traced.stop),
            poses, gated, scan_at)
    run.checks.update(nums)
    if control is not None:
        run.info["control"] = control
