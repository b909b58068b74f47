"""A fleet of robots, each with a map of its own, served together through
``FleetSession.process_ranges``, open loop at the sensors' rate.

Set-up: the seed's laps (one per robot, each robot in a world of its own
clutter, from its own start on the loop), the fleet session, and a
warm-up lap of ticks back to back through the session (it captures the
fleet step's graph and builds the maps the window starts on). Window:
``rate_hz * seconds`` ticks, tick k due at t0 + k / rate_hz whether or
not tick k-1 has finished, every robot's newest scan in each; a
robot-scan's time runs from its tick's due time to all R poses in host
memory. The laps go on where the warm-up left them. Judged: every
robot's every pose and gate, warm-up included, and every robot's map at
the end, each robot along its own path as one robot is
(``reference/judge.py``); the fleet's numbers are the widest gaps and
the summed counts over its robots.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import judge, slam_ref
from ..sim import traffic as sim
from . import common
from .session_open_loop import reference_scans

SUMMED = ("gate_mismatches", "map_cells_off", "non_finite")


def combined(per_robot):
    """The fleet's numbers from each robot's: the widest gaps, the summed
    counts."""
    out = {}
    for nums in per_robot:
        for k, v in nums.items():
            if k == "log":
                continue
            out[k] = out.get(k, 0) + v if k in SUMMED \
                else max(out.get(k, v), v)
    return out


def judge_fleet(run, laps, poses, gated, maps):
    """(numbers, the control's numbers or None) of the fleet's path:
    poses f32[T, R, 3], gates bool[T, R], maps per level [R, H, W]."""
    cell, dev = run.cell, torch.device(run.device)
    p = slam_ref.params(cell.config)
    n_lap = laps.ranges.shape[1]
    origo = torch.zeros((1, 2), dtype=torch.float64, device=dev)
    nums, control = [], []
    for r in range(poses.shape[1]):
        pts, keep = reference_scans(cell.config, laps.ranges[r], dev)

        def scan_at(t):
            return pts[t % n_lap][None], origo, keep[t % n_lap][None]

        path = torch.from_numpy(np.ascontiguousarray(poses[:, r:r + 1]))
        got, _ = judge.judge_path(
            p, path, torch.from_numpy(np.ascontiguousarray(
                gated[:, r:r + 1])), [lo[r:r + 1] for lo in maps],
            scan_at, dev)
        run.note(f"robot {r}: {got['log']}")
        nums.append(got)
        if run.info.get("with_control"):
            control.append(judge.control_path(p, path, scan_at, dev))
    return combined(nums), (combined(control) if control else None)


def main(run) -> None:
    import hector_slam_tpu_torch as hs
    # a program without the fleet front end stops here, before any work
    from hector_slam_tpu_torch import FleetSession

    cell, tr = run.cell, run.cell.traffic
    dev = torch.device(run.device)
    cfg = common.slam_config(hs, cell.config)
    rate = float(cell.config["laser"]["rate_hz"])
    robots = int(cell.config["robots"])
    laps = sim.make_laps(tr, cell.config["laser"], robots, run.seed, dev)
    # [L, R, B]: tick i takes row i mod L, every robot's scan of it
    ticks = np.ascontiguousarray(
        laps.ranges.cpu().numpy().transpose(1, 0, 2))
    n_lap = ticks.shape[0]
    n_warm = tr["warmup_laps"] * n_lap
    n_win = int(round(run.seconds * rate))
    total = n_warm + n_win
    poses = np.zeros((total, robots, 3), np.float32)
    gated = np.zeros((total, robots), bool)

    fleet = FleetSession(cfg, common.laser_model(hs, cell.config), robots,
                         device=dev)
    for i in range(n_warm):
        poses[i] = fleet.process_ranges(ticks[i % n_lap])
        gated[i] = fleet.gates
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
        latency[k] = end - due
        started_late[k] = begin - due
    run.tracer.stop()
    window_s = end - t0

    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.info["traced_steps"] = len(traced)
    run.info["traced_started_late_s"] = started_late[traced.start:
                                                     traced.stop].tolist()
    run.attempted = n_win * robots
    run.failed = common.non_finite(poses[n_warm:].reshape(-1, 3))
    per_scan = np.repeat(latency, robots)
    run.e2e["scan_p95_ms"] = float(np.percentile(per_scan, 95) * 1e3)
    late = float((latency > 1.0 / rate).mean() * 100.0)
    run.note(f"window {window_s:.3f} s for {n_win} ticks of {robots} robots "
             f"at {rate} Hz; robot-scan p50 "
             f"{np.percentile(per_scan, 50) * 1e3:.3f} ms p95 "
             f"{run.e2e['scan_p95_ms']:.3f} ms max {latency.max() * 1e3:.3f}"
             f" ms; ticks past one period {late:.2f}%; gated "
             f"{gated[n_warm:].mean() * 100:.2f}% of the window's "
             f"robot-scans")

    maps = [lo.clone() for lo in fleet.state.log_odds]
    del fleet
    common.free_program(dev)
    t_ref = time.perf_counter()
    nums, control = judge_fleet(run, laps, poses, gated, maps)
    run.note(f"reference: {total} ticks of {robots} robots judged in "
             f"{time.perf_counter() - t_ref:.2f} s")
    run.checks.update(nums)
    if control is not None:
        run.info["control"] = control
