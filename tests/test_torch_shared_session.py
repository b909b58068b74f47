"""The shared-map fleet front end (``FleetSession(..., shared_map=True)``)
on the CPU, and the shared-map cell's reference, judge, faults, readers
and paint roofline (``benchmark/``).

The session is bit-equal to stepping ``shared_fleet_step`` by hand on the
same conversions; the per-robot mode is as it was; at a small map with 4
robots on seeded shared-world laps the session's poses, gates and map are
within the cell's limits of the plain reference
(``benchmark/reference/shared_ref.py``), and the judge fails the
bfloat16 control and each planted fault (``benchmark/tools/
shared_faults.py``); the reference's one-tick union equals the OR of
the robots' own cell sets, occupied winning.

Scans: the cell's own generator (``benchmark/sim/shared.py``) at the
benchmark's CPU test size (``benchmark/tests/tiny.py``: 256^2 x 2 at
0.1 m, 181 beams, 120-scan laps), 4 robots.

The ``cuda`` test holds the served path on the card at the cell's size
(64 robots on one 1024^2 x 3 map at 0.025 m): one capture, then replays,
bit-equal to the eager ``shared_fleet_step``. This file imports no JAX;
run it on a machine with a card with

    python -m pytest --noconftest -q -m cuda tests/test_torch_shared_session.py
"""

import inspect
import json
import math
import time

import numpy as np
import pytest
import torch

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch import tracing
from hector_slam_tpu_torch.core import graphs
from hector_slam_tpu_torch.io.scanlog import (beam_directions,
                                              scans_from_ranges)
from test_torch_graphs_replay import as_on_card  # noqa: F401 (fixture)
from test_torch_tracing import (FreshCounters, _events, _inside, _spans,
                                fresh)  # noqa: F401 (fixture)

CELL = "shared40.node-default-1024x3-shared64"
ROBOTS = 4
TICKS = 40
SEED = 2 ** 31 + 11
READERS = ("shared.device_ms_per_step", "device.idle_in_shared_step",
           "shared.convert_ms_per_step", "shared.read_ms_per_step",
           "shared.host_ms_per_step", "shared.map_write_share",
           "raster_paint.roofline", "shared.gated_share",
           "shared.graph_captures", "shared.kernels_per_step")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cell(robots=ROBOTS):
    from benchmark.tests import tiny
    cell = tiny.tiny_cell(CELL)
    cell.config["robots"] = robots
    return cell


def _setup(cell, device="cpu", seed=SEED):
    from benchmark.drivers import common
    from benchmark.sim import shared
    cfg = common.slam_config(ht, cell.config)
    laser = common.laser_model(ht, cell.config)
    laps = shared.make_shared_laps(cell.traffic, cell.config["laser"],
                                   cell.config["robots"], seed, device)
    return cfg, laser, laps


@pytest.fixture(scope="module")
def small():
    """(cell, cfg, laser, laps, ticks [T, R, B] on the host)."""
    cell = _cell()
    cfg, laser, laps = _setup(cell)
    ticks = np.ascontiguousarray(laps.ranges[:, :TICKS].numpy()
                                 .transpose(1, 0, 2))
    return cell, cfg, laser, laps, ticks


def _run_shared(cfg, laser, ticks, starts, device="cpu"):
    fleet = ht.FleetSession(cfg, laser, ticks.shape[1], device=device,
                            shared_map=True, start_poses=starts)
    poses, gates, written = [], [], []
    for r in ticks:
        poses.append(fleet.process_ranges(r))
        gates.append(fleet.gates.copy())
        written.append(fleet.map_written)
    return fleet, np.stack(poses), np.stack(gates), np.array(written)


@pytest.fixture(scope="module")
def served(small):
    _, cfg, laser, laps, ticks = small
    with FreshCounters():
        return _run_shared(cfg, laser, ticks, laps.starts)


def _bits(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# ---- the session against the step by hand ----------------------------------

def test_shared_session_equals_shared_fleet_step_by_hand(small, served):
    _, cfg, laser, laps, ticks = small
    fleet, poses, gates, written = served
    assert written.any() and not written.all()
    assert np.array_equal(written, gates.any(1))
    assert fleet.timing_stats()["count"] == TICKS
    state = ht.init_shared_fleet(cfg, ROBOTS, laps.starts, device="cpu")
    dirs = beam_directions(laser, ticks.shape[2], "cpu")
    for t, rows in enumerate(ticks):
        scans = scans_from_ranges(torch.from_numpy(rows), dirs,
                                  cfg.map.level_scale(0), laser,
                                  cfg.max_beams)
        state, metrics = ht.shared_fleet_step(state, scans, cfg)
        assert np.array_equal(poses[t].view(np.int32),
                              state.pose.numpy().view(np.int32)), t
        assert np.array_equal(gates[t], metrics.map_updated.numpy()), t
    for a, b in zip(state.log_odds + state.quads,
                    fleet.state.log_odds + fleet.state.quads):
        assert torch.equal(_bits(a), _bits(b))
    assert int(state.map_update_count) == int(written.sum())
    # the robots start where they were told, in the map's frame
    fresh = ht.FleetSession(cfg, laser, ROBOTS, device="cpu",
                            shared_map=True, start_poses=laps.starts)
    assert np.array_equal(fresh.state.pose.numpy().view(np.int32),
                          laps.starts.view(np.int32))


def test_per_robot_mode_is_unchanged(small, fresh):
    """The default mode steps ``fleet_step_jit`` with a map a robot and
    counts what it counted; ``start_poses`` belongs to the shared mode."""
    _, cfg, laser, laps, ticks = small
    fleet = ht.FleetSession(cfg, laser, ROBOTS, device="cpu")
    assert not fleet.shared_map
    assert fleet.state.log_odds[0].shape[0] == ROBOTS
    state = ht.init_fleet(cfg, ROBOTS, device="cpu")
    dirs = beam_directions(laser, ticks.shape[2], "cpu")
    for rows in ticks[:12]:
        poses = fleet.process_ranges(rows)
        assert not fleet.map_written
        state, metrics = ht.fleet_step(state, scans_from_ranges(
            torch.from_numpy(rows), dirs, cfg.map.level_scale(0), laser,
            cfg.max_beams), cfg)
        assert np.array_equal(poses.view(np.int32),
                              state.pose.numpy().view(np.int32))
        assert np.array_equal(fleet.gates, metrics.map_updated.numpy())
    c = tracing.counters()
    assert c["fleet.robot_steps"] == 12 * ROBOTS
    assert "fleet.map_writes" not in c
    assert c.get("graph.host[shared_fleet_step_jit]", 0) == 0
    with pytest.raises(ValueError, match="shared_map"):
        ht.FleetSession(cfg, laser, ROBOTS, device="cpu",
                        start_poses=laps.starts)
    with pytest.raises(ValueError, match="start_poses"):
        ht.FleetSession(cfg, laser, ROBOTS, device="cpu", shared_map=True,
                        start_poses=laps.starts[:2])


# ---- against the reference -------------------------------------------------

def _tiny_run(seconds=0.5, control=False, seed=SEED):
    from benchmark.harness import core, trace
    import benchmark.drivers.shared_open_loop as driver
    run = core.Run(_cell(), seed, seconds, trace.Tracer(False),
                   time.perf_counter(), device="cpu")
    run.info["with_control"] = control
    driver.main(run)
    return run


@pytest.fixture(scope="module")
def sound_run():
    with FreshCounters():
        return _tiny_run(control=True)


def test_shared_session_is_within_the_cell_limits(sound_run):
    from benchmark.harness import core
    correct, checks = core.judged(sound_run)
    assert correct, checks
    assert sound_run.attempted == 20 * ROBOTS and sound_run.failed == 0
    assert sound_run.e2e["scan_p95_ms"] > 0


def test_control_is_not_within_the_cell_limits(sound_run):
    from benchmark.harness import core
    correct, checks = core.judged(core.as_control(sound_run))
    assert not correct, checks


@pytest.mark.parametrize("kind", ["left_out", "unwritten", "moved"])
def test_planted_fault_is_not_within_the_cell_limits(monkeypatch, kind):
    """Every run fails, also the second of two seeds in one process (the
    calibration runs many seeds in one)."""
    from benchmark.harness import core
    from benchmark.tools import shared_faults
    target, name, broken = shared_faults.shared_fault(kind)
    monkeypatch.setattr(target, name, broken)
    for seed in (SEED, SEED + 1):
        with FreshCounters():
            run = _tiny_run(seconds=1.0, seed=seed)
        correct, checks = core.judged(run)
        assert not correct, (seed, checks)


def test_driver_stops_before_any_work_without_a_shared_mode(monkeypatch):
    """A program whose ``FleetSession`` has no shared map (one from
    before the shared mode) fails at once, before the traffic is made."""
    from benchmark.harness import core, trace
    from benchmark.sim import shared
    import benchmark.drivers.shared_open_loop as driver

    class PerRobotOnly:
        def __init__(self, cfg=None, laser=None, robots=1, device="cuda"):
            raise AssertionError("constructed")

    def no_laps(*args, **kwargs):
        raise AssertionError("traffic made")

    monkeypatch.setattr(ht, "FleetSession", PerRobotOnly)
    monkeypatch.setattr(shared, "make_shared_laps", no_laps)
    run = core.Run(_cell(), SEED, 0.5, trace.Tracer(False),
                   time.perf_counter(), device="cpu")
    with pytest.raises(RuntimeError, match="shared-map mode"):
        driver.main(run)
    assert "shared_map" in inspect.signature(ht.fleet_session.FleetSession
                                             ).parameters


def test_one_tick_union_is_the_robots_or_with_occupied_winning(small):
    """``shared_ref.union_update`` of the gated robots' scans equals the
    cell sets each robot paints alone, OR-ed, occupied winning, applied
    once (with the occupied clamp)."""
    from benchmark.drivers.session_open_loop import reference_scans
    from benchmark.reference import shared_ref, slam_ref
    cell, _, _, laps, _ = small
    p = slam_ref.params(cell.config)
    pts, keep = reference_scans(cell.config, laps.ranges[:, 7], "cpu")
    origo = torch.zeros((ROBOTS, 2), dtype=torch.float64)
    poses = torch.from_numpy(laps.poses[:, 7])
    gated = torch.tensor([True, False, True, True])
    # each robot's own sets, from its own scan painted into zeros
    alone = slam_ref.init_maps(p, ROBOTS, "cpu", torch.float64)
    slam_ref.update(p, alone, torch.arange(ROBOTS), poses, pts, origo, keep)
    gen = torch.Generator().manual_seed(3)
    for lv in range(len(p.levels)):
        occ = (alone[lv] == p.log_odds_occupied)[gated].any(0)
        free = (alone[lv] == p.log_odds_free)[gated].any(0) & ~occ
        assert occ.any() and free.any() and (free | occ).sum() < (
            ((alone[lv] != 0)[gated]).sum())
        for old in (torch.zeros(occ.shape, dtype=torch.float64),
                    torch.randint(-3, 60, occ.shape, generator=gen
                                  ).to(torch.float64)):
            maps = [torch.zeros((1,) + m.shape[1:], dtype=torch.float64)
                    for m in alone]
            maps[lv][0] = old
            shared_ref.union_update(p, maps, gated, poses, pts, origo, keep)
            want = old + p.log_odds_free * free.double() \
                + p.log_odds_occupied * (occ & (old < p.clamp_occupied)
                                         ).double()
            assert torch.equal(maps[lv][0], want), lv


def test_cell_configuration_is_the_node_defaults():
    """The cell runs ``DEFAULT_CONFIG`` (the node's parameter defaults)
    for BASELINE.json's 64 robots on one card, nothing cut."""
    from benchmark.drivers import common
    from benchmark.harness import spec
    conf = spec.find_cell(CELL).config
    assert common.slam_config(ht, conf) == ht.DEFAULT_CONFIG
    assert (conf["robots"], conf["chips"], conf["reduced"]) == (64, 1, [])
    assert conf["shared_map"] and conf["laser"]["rate_hz"] == 40


# ---- the paint's roofline ---------------------------------------------------

GATE_PATTERNS = {"all": [True] * ROBOTS, "one": [False, True, False, False],
                 "none": [False] * ROBOTS}


@pytest.mark.parametrize("gates", list(GATE_PATTERNS))
def test_paint_bound_is_at_most_the_kernel_traffic(small, gates):
    """``roofline/raster_paint.tick_bytes`` of one tick never exceeds
    what the paint kernel itself moves for that tick: each scan's inputs
    and each slot's mask read once a level, each painted beam's point
    once a level, one byte a stored cell (the cells of the program's
    painted grids, the plain version's on the CPU, counted once a grid);
    the grids' zero fill is no part of it."""
    from benchmark.drivers.shared_open_loop import (paint_bytes,
                                                    reference_scan_at)
    from benchmark.reference import slam_ref
    from benchmark.roofline import raster_paint as rp
    from hector_slam_tpu_torch.core.mapping import paint_pyramid
    cell, cfg, laser, laps, ticks = small
    t = 5
    gate = torch.tensor(GATE_PATTERNS[gates])
    poses = laps.poses[:, t].astype(np.float32)
    state = ht.init_shared_fleet(cfg, ROBOTS, poses, device="cpu")
    scans = scans_from_ranges(torch.from_numpy(ticks[t]),
                              beam_directions(laser, ticks.shape[2], "cpu"),
                              cfg.map.level_scale(0), laser, cfg.max_beams)
    sets, _ = paint_pyramid(state.log_odds, state.pose, scans, cfg,
                            gates=gate)
    levels = len(sets)
    painted = int((scans.mask & gate[:, None]).sum())
    stored = sum(int(g.sum()) for pair in sets for g in pair)
    kernel = (levels * (rp.SCAN_BYTES * ROBOTS
                        + rp.MASK_BYTES * scans.mask.numel()
                        + rp.POINT_BYTES * painted) + stored)
    scan_at = reference_scan_at(cell, laps, "cpu")
    gated = np.zeros((t + 1, ROBOTS), bool)
    gated[t] = gate.numpy()
    path = np.zeros((t + 1, ROBOTS, 3), np.float32)
    path[t] = poses
    [bound] = paint_bytes(cell, [t], path, gated, scan_at)
    assert 0 < bound <= kernel
    p = slam_ref.params(cell.config)
    pts, origo, mask = scan_at(t)
    cells = rp.stored_cells(p, torch.from_numpy(poses)[gate], pts[gate],
                            origo[gate], mask[gate])
    assert bound == rp.launch_bytes(ROBOTS, scans.mask.numel(), painted,
                                    cells)
    assert cells <= stored
    grids = sum(g.numel() for pair in sets for g in pair)
    if gates == "none":
        assert stored == cells == painted == 0
        assert bound == (rp.SCAN_BYTES + rp.MASK_BYTES * cfg.max_beams) \
            * ROBOTS < grids
    else:
        # the reference's cells are the program's up to a few rounded rays
        assert cells >= 0.98 * max(int(g.sum()) for pair in sets
                                   for g in pair)


def test_paint_launch_bytes_by_hand():
    from benchmark.roofline import raster_paint as rp
    # 2 scans of 8 slots, 3 beams painted, 10 cells stored
    assert rp.launch_bytes(2, 16, 3, 10) == 2 * 28 + 16 + 3 * 8 + 10
    assert rp.launch_bytes(64, 64 * 1152, 0, 0) == 64 * 28 + 64 * 1152


def test_paint_roofline_reads_the_counted_ticks():
    """The reader divides the counted ticks' least time by the traced
    launches' time, and reads nothing where the launches and the counted
    ticks differ in number."""
    from benchmark.harness import core, spec, trace
    from benchmark.roofline import formulas
    run = core.Run(spec.find_cell(CELL), 0, 0.0, trace.Tracer(False), 0.0,
                   device="cpu")
    rows = [("raster_paint_kernel", 10.0 * k, 30.0, "kernel")
            for k in range(2)] + [("fill_kernel", 5.0, 9.0, "kernel")]
    run.tracer.trace = trace.Trace(0.0, 100.0, rows, [])
    run.info["raster_paint_bytes"] = [100_000, 200_000]
    reader = spec.metric_reader("raster_paint.roofline")
    want = 100.0 * formulas.least_s(0.0, 300_000.0) / 60e-6
    assert reader.read(run) == pytest.approx(want, rel=1e-12)
    run.info["raster_paint_bytes"] = [100_000]
    assert reader.read(run) is None


# ---- spans, counters and readers -------------------------------------------

def test_ticks_under_a_profiler_hold_their_spans(as_on_card, small,
                                                 tmp_path, fresh):
    _, cfg, laser, laps, ticks = small
    fleet = ht.FleetSession(cfg, laser, ROBOTS, device="cpu",
                            shared_map=True, start_poses=laps.starts)
    fleet.process_ranges(ticks[0])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for r in ticks[1:4]:
            fleet.process_ranges(r)
    spans = _spans(_events(prof, tmp_path))
    roots = [s for s in spans if s[0] == "hs.fleet"]
    assert len(roots) == 3
    for root in roots:
        parts = {}
        for name in ("hs.fleet.convert", "hs.graph:shared_fleet_step_jit",
                     "hs.fleet.read"):
            [parts[name]] = [s for s in spans
                             if s[0] == name and _inside(s, root)]
        conv, call, read = parts.values()
        assert conv[1] + conv[2] <= call[1]
        assert call[1] + call[2] <= read[1]
    assert not [s for s in spans if s[0] == "hs.graph:fleet_step_jit"]
    c = tracing.counters()
    assert c["fleet.step"] == 4 and c["fleet.step.timed"] == 0
    assert c["fleet.convert.timed"] == c["fleet.read.timed"] == 1


def test_counters_count_robot_steps_gates_and_map_writes(small, fresh):
    _, cfg, laser, laps, ticks = small
    fleet, _, gates, written = _run_shared(cfg, laser, ticks[:12],
                                           laps.starts)
    c = tracing.counters()
    assert c["fleet.robot_steps"] == 12 * ROBOTS
    assert c["fleet.gated"] == int(gates.sum())
    assert c["fleet.map_writes"] == int(written.sum()) == int(
        fleet.state.map_update_count)
    assert 0 < c["fleet.map_writes"] < 12
    for name in ("fleet.step", "fleet.convert", "fleet.read"):
        assert c[name] == c[name + ".timed"] == 12 and c[name + ".ns"] > 0


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_counters_or_a_trace(name, fresh):
    from benchmark.harness import core, spec, trace
    cell = spec.find_cell(CELL)
    run = core.Run(cell, 0, 0.0, trace.Tracer(False), 0.0, device="cpu")
    assert spec.metric_reader(name).read(run) is None
    entry = [m for m in json.loads((spec.ROOT / "BENCHMARK.json")
                                   .read_text())["per_layer"]
             if m["name"] == name]
    assert len(entry) == 1 and entry[0]["workloads"] == [CELL]
    assert entry[0]["moves"] == ("setup_s" if name == "shared.graph_captures"
                                 else "scan_p95_ms")


@pytest.mark.parametrize("name", ["shared.convert_ms_per_step",
                                  "shared.read_ms_per_step",
                                  "shared.host_ms_per_step",
                                  "shared.map_write_share",
                                  "shared.gated_share",
                                  "shared.graph_captures"])
def test_counter_reader_reads_a_shared_run(as_on_card, small, name, fresh):
    """On the graph path (rehearsed on the CPU): the first tick captures
    and is left out of the timers, the other ticks are read."""
    from benchmark.harness import core, spec, trace
    _, cfg, laser, laps, ticks = small
    _, _, gates, written = _run_shared(cfg, laser, ticks[:8], laps.starts)
    c = tracing.counters()
    assert c["graph.host[shared_fleet_step_jit]"] == 8
    assert c["graph.host[shared_fleet_step_jit].timed"] == 7
    run = core.Run(spec.find_cell(CELL), 0, 0.0, trace.Tracer(False), 0.0,
                   device="cpu")
    value = spec.metric_reader(name).read(run)
    assert value is not None and math.isfinite(value) and value > 0
    if name == "shared.map_write_share":
        assert value == 100.0 * written.sum() / 8
    if name == "shared.gated_share":
        assert value == 100.0 * gates.sum() / (8 * ROBOTS)
    if name == "shared.graph_captures":
        assert value == 1.0


# ---- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_shared_session_bit_equal_to_eager_shared_fleet_step_on_card():
    """The served path at the cell's size: 64 robots on one 1024^2 x 3
    map through ``FleetSession(shared_map=True)`` (the captured
    ``shared_fleet_step_jit``: one capture, then a replay a tick)
    against the eager ``shared_fleet_step`` on the same conversions, bit
    for bit, over 60 ticks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    from benchmark.harness import spec
    graphs.clear()
    dev = torch.device("cuda")
    cell = spec.find_cell(CELL)
    cfg, laser, laps = _setup(cell, dev)
    robots = cell.config["robots"]
    ticks = np.ascontiguousarray(laps.ranges[:, :60].cpu().numpy()
                                 .transpose(1, 0, 2))
    captures = graphs.totals()["captures"]
    fleet = ht.FleetSession(cfg, laser, robots, device=dev, shared_map=True,
                            start_poses=laps.starts)
    eager = ht.init_shared_fleet(cfg, robots, laps.starts, dev)
    dirs = beam_directions(laser, ticks.shape[2], dev)
    written = 0
    for t, rows in enumerate(ticks):
        poses = fleet.process_ranges(rows)
        scans = scans_from_ranges(torch.from_numpy(rows).to(dev), dirs,
                                  cfg.map.level_scale(0), laser,
                                  cfg.max_beams)
        eager, metrics = ht.shared_fleet_step(eager, scans, cfg)
        assert np.array_equal(poses.view(np.int32),
                              eager.pose.cpu().numpy().view(np.int32)), t
        assert np.array_equal(fleet.gates, metrics.map_updated.cpu()
                              .numpy()), t
        assert fleet.map_written == bool(fleet.gates.any())
        written += fleet.map_written
    assert 0 < written < 60
    for a, b in zip(fleet.state.log_odds + fleet.state.quads,
                    eager.log_odds + eager.quads):
        assert torch.equal(_bits(a), _bits(b))
    assert int(fleet.state.map_update_count) == written
    [entry] = [g for g in graphs.stats()
               if g.name == "shared_fleet_step_jit"]
    assert entry.replays == 60
    assert graphs.totals()["captures"] == captures + 1
    assert entry.per_replay["raster_paint"] == 1
    graphs.clear()
