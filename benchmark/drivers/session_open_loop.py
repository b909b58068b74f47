"""One robot's live scans through ``SlamSession.process_ranges``, open
loop at the sensor's rate.

Set-up: the seed's lap of scans, the session, and a warm-up lap through
the session (it captures the step's graph and builds the map the window
starts on). Window: ``rate_hz * seconds`` scans, scan k due at
t0 + k / rate_hz whether or not scan k-1 has finished; a scan's time runs
from its due time to its pose in host memory. The lap goes on where the
warm-up left it. Judged: every scan's pose and gate, warm-up included,
and the map at the end (``reference/judge.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import judge, slam_ref
from ..sim import traffic as sim
from . import common


def reference_scans(cfg: dict, ranges: torch.Tensor, device):
    """The reference's own conversion of ranges f32[L, B] to points
    f64[L, B, 2] in finest-level map units and a mask (keep ranges in
    (range_min, range_max - 0.1))."""
    laser = cfg["laser"]
    p = slam_ref.params(cfg)
    r = ranges.to(device, torch.float64)
    ang = torch.tensor(sim.laser_angles(laser), dtype=torch.float64,
                       device=device)
    keep = (ranges > np.float32(laser["range_min"])) & (
        ranges < np.float32(laser["range_max"] - 0.1))
    d = r * p.levels[0].scale
    pts = torch.stack([torch.cos(ang) * d, torch.sin(ang) * d], -1)
    return torch.where(keep.to(device)[..., None], pts, 0.0), keep.to(device)


def main(run) -> None:
    import hector_slam_tpu_torch as hs

    cell, tr = run.cell, run.cell.traffic
    dev = torch.device(run.device)
    cfg = common.slam_config(hs, cell.config)
    rate = float(cell.config["laser"]["rate_hz"])
    laps = sim.make_laps(tr, cell.config["laser"], 1, run.seed, dev)
    lap = laps.ranges[0].cpu().numpy()
    n_lap = lap.shape[0]
    n_warm = tr["warmup_laps"] * n_lap
    n_win = int(round(run.seconds * rate))
    total = n_warm + n_win
    poses = np.zeros((total, 3), np.float32)
    gated = np.zeros(total, bool)
    at = [0]

    def on_update(_session):
        gated[at[0]] = True

    session = hs.SlamSession(cfg, common.laser_model(hs, cell.config),
                             on_map_update=on_update, device=dev)
    for i in range(n_warm):
        at[0] = i
        poses[i] = session.process_ranges(lap[i % n_lap])
    run.tracer.warm()
    scans_before = session.timing_stats()["count"]
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
        at[0] = i
        due = t0 + k / rate
        with run.tracer.span("traffic.wait_due"):
            common.wait_until(due)
        begin = time.perf_counter()
        with run.tracer.span("session.process_ranges"):
            poses[i] = session.process_ranges(lap[i % n_lap])
        end = time.perf_counter()
        latency[k] = end - due
        started_late[k] = begin - due
    run.tracer.stop()
    window_s = end - t0

    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    # the session's own timing stats, kept for the window's scans only
    window_ms = session._scan_times_ms[scans_before:]
    if len(window_ms) != n_win:
        raise RuntimeError(f"the session timed {len(window_ms)} of the "
                           f"window's {n_win} scans")
    run.info["session_scan_ms"] = window_ms
    run.info["traced_scans"] = len(traced)
    run.info["traced_started_late_s"] = started_late[traced.start:
                                                     traced.stop].tolist()
    run.attempted = n_win
    run.failed = common.non_finite(poses[n_warm:])
    run.e2e["scan_p95_ms"] = float(np.percentile(latency, 95) * 1e3)
    # the generator's own lateness: scans whose predecessor had finished
    # before they were due started this late
    idle = started_late[1:][latency[:-1] - 1.0 / rate < 0] if n_win > 1 \
        else started_late[:0]
    run.note(f"window {window_s:.3f} s for {n_win} scans at {rate} Hz; "
             f"scan p50 {np.percentile(latency, 50) * 1e3:.3f} ms p95 "
             f"{run.e2e['scan_p95_ms']:.3f} ms max {latency.max() * 1e3:.3f} "
             f"ms; generator late p50 "
             f"{np.percentile(idle, 50) * 1e6 if len(idle) else 0:.1f} us "
             f"max {idle.max() * 1e6 if len(idle) else 0:.1f} us over "
             f"{len(idle)} scans due on an idle system")

    maps = [lo[None].clone() for lo in session.state.log_odds]
    del session
    common.free_program(dev)
    t_ref = time.perf_counter()
    pts, keep = reference_scans(cell.config, laps.ranges[0], dev)
    origo = torch.zeros((1, 2), dtype=torch.float64, device=dev)

    def scan_at(t):
        return pts[t % n_lap][None], origo, keep[t % n_lap][None]

    path = torch.from_numpy(poses)[:, None]
    nums, _ = judge.judge_path(slam_ref.params(cell.config), path,
                               torch.from_numpy(gated)[:, None], maps,
                               scan_at, dev)
    run.note(f"reference: {total} scans judged in "
             f"{time.perf_counter() - t_ref:.2f} s; {nums.pop('log')}")
    run.checks.update(nums)
    if run.info.get("with_control"):
        run.info["control"] = judge.control_path(
            slam_ref.params(cell.config), path, scan_at, dev)
