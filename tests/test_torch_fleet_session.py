"""The fleet front end (hector_slam_tpu_torch/fleet_session.py) on the
CPU: its batched conversion is bit-equal per robot to
``scan_from_ranges``; a ``FleetSession`` of 3 robots is bit-equal to 3
solo ``SlamSession``s (poses, gates, final levels and quads); its
answers are within the fleet cell's limits of the benchmark's plain
reference (``benchmark/reference``), and a fleet whose state is left
unchanged is not; its spans nest and its counters count; the fleet
cell's readers read nothing from a run with no counters or no trace.

Scans: the fleet cell's own traffic generator at the benchmark's CPU
test size (``benchmark/tests/tiny.py``: 256^2 x 2 at 0.1 m, 181 beams,
120-scan laps), 3 robots, the first ``TICKS`` ticks.

The ``cuda`` test holds the served path on the card at the cell's size
(8 robots x 2048^2 x 2) bit-equal to the eager ``fleet_step`` and to two
robots' solo sessions. This file imports no JAX; run it on a machine
with a card with

    python -m pytest --noconftest -q -m cuda tests/test_torch_fleet_session.py
"""

import json
import math

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

CELL = "fleet40.tutorial-2048x2-fleet8"
ROBOTS = 3
TICKS = 40
READERS = ("fleet.device_ms_per_step", "device.idle_in_step",
           "fleet.convert_ms_per_step", "fleet.read_ms_per_step",
           "fleet.host_ms_per_step", "fleet.gated_share")


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


def _setup(cell, device="cpu"):
    from benchmark.drivers import common
    from benchmark.sim import traffic as sim
    cfg = common.slam_config(ht, cell.config)
    laser = common.laser_model(ht, cell.config)
    laps = sim.make_laps(cell.traffic, cell.config["laser"],
                         cell.config["robots"], 2 ** 31 + 11, device)
    return cfg, laser, laps


@pytest.fixture(scope="module")
def small():
    """(cell, cfg, laser, laps, ticks [T, R, B] on the host)."""
    cell = _cell()
    cfg, laser, laps = _setup(cell)
    ticks = np.ascontiguousarray(laps.ranges[:, :TICKS].numpy()
                                 .transpose(1, 0, 2))
    return cell, cfg, laser, laps, ticks


def _run_fleet(cfg, laser, ticks, device="cpu"):
    fleet = ht.FleetSession(cfg, laser, ticks.shape[1], device=device)
    poses, gates = [], []
    for r in ticks:
        poses.append(fleet.process_ranges(r))
        gates.append(fleet.gates.copy())
    return fleet, np.stack(poses), np.stack(gates)


@pytest.fixture(scope="module")
def served(small):
    _, cfg, laser, _, ticks = small
    with FreshCounters():
        return _run_fleet(cfg, laser, ticks)


def _bits(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# ---- the batched conversion ----------------------------------------------

def _edge_ranges(laser, rng):
    """Rows that each test one rule of the conversion: in-range noise,
    beams at and beyond both range limits, NaN and inf, all dropped."""
    b = laser.num_beams
    rows = [rng.uniform(0.0, laser.range_max + 1.0, b)]
    edge = rng.uniform(0.5, 5.0, b)
    edge[::7] = laser.range_min
    edge[1::7] = np.float32(laser.range_max - 0.1)
    edge[2::7] = np.nan
    edge[3::7] = np.inf
    edge[4::7] = -1.0
    rows += [edge, np.full(b, np.nan), np.full(b, 2.5)]
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("max_beams", [181, 192, 256])
def test_batched_conversion_is_bit_equal_per_robot(small, max_beams):
    _, cfg, laser, _, ticks = small
    rows = np.concatenate([ticks[0], ticks[TICKS - 1],
                           _edge_ranges(laser, np.random.default_rng(5))])
    got = scans_from_ranges(torch.from_numpy(rows),
                            beam_directions(laser, rows.shape[1], "cpu"),
                            cfg.map.level_scale(0), laser, max_beams)
    assert got.points.shape == (len(rows), max_beams, 2)
    for r, ranges in enumerate(rows):
        want = ht.scan_from_ranges(ranges, cfg.map.level_scale(0), laser,
                                   max_beams, device="cpu")
        assert torch.equal(_bits(got.points[r]), _bits(want.points)), r
        assert torch.equal(got.mask[r], want.mask), r
        assert torch.equal(_bits(got.origo[r]), _bits(want.origo)), r


def test_batched_conversion_refuses_more_beams_than_max_beams(small):
    _, cfg, laser, _, ticks = small
    with pytest.raises(ValueError, match="max_beams"):
        scans_from_ranges(torch.from_numpy(ticks[0]),
                          beam_directions(laser, ticks.shape[2], "cpu"),
                          cfg.map.level_scale(0), laser, 180)
    fleet = ht.FleetSession(cfg, laser, ROBOTS, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        fleet.process_ranges(ticks[0, :2])
    with pytest.raises(ValueError, match="expected"):
        fleet.process_ranges(np.ones((ROBOTS, laser.num_beams + 1)))


# ---- against solo sessions and the reference ------------------------------

def test_fleet_session_equals_solo_sessions(small, served):
    _, cfg, laser, _, ticks = small
    fleet, poses, gates = served
    assert gates.any(0).all() and not gates.all()
    assert fleet.timing_stats()["count"] == TICKS
    for r in range(ROBOTS):
        fired = []
        solo = ht.SlamSession(cfg, laser, device="cpu",
                              on_map_update=lambda s: fired.append(True))
        for t in range(TICKS):
            n = len(fired)
            pose = solo.process_ranges(ticks[t, r])
            assert np.array_equal(pose.view(np.int32),
                                  poses[t, r].view(np.int32)), (r, t)
            assert (len(fired) > n) == gates[t, r], (r, t)
        for a, b in zip(solo.state.log_odds + solo.state.quads,
                        fleet.state.log_odds + fleet.state.quads):
            assert torch.equal(_bits(a), _bits(b[r])), r
        assert int(solo.state.map_update_count) == int(gates[:, r].sum())


def _judged(cell, laps, poses, gates, maps):
    """``core.judged`` of ``fleet_open_loop.judge_fleet``'s numbers for this
    path."""
    from benchmark.drivers import fleet_open_loop
    from benchmark.harness import core, trace
    run = core.Run(cell, 0, 0.0, trace.Tracer(False), 0.0, device="cpu")
    nums, _ = fleet_open_loop.judge_fleet(run, laps, poses, gates, maps)
    run.checks.update(nums)
    return core.judged(run)


def test_fleet_session_is_within_the_cell_limits(small, served):
    cell, _, _, laps, _ = small
    fleet, poses, gates = served
    correct, checks = _judged(cell, laps, poses, gates,
                              list(fleet.state.log_odds))
    assert correct, checks


def test_unchanged_fleet_is_not_within_the_cell_limits(small, served):
    cell, cfg, _, laps, _ = small
    _, poses, gates = served
    fresh = ht.init_fleet(cfg, ROBOTS, device="cpu")
    correct, checks = _judged(cell, laps, np.zeros_like(poses),
                              np.zeros_like(gates), list(fresh.log_odds))
    assert not correct, checks


# ---- spans and counters ----------------------------------------------------

def test_ticks_under_a_profiler_hold_their_spans(as_on_card, small,
                                                 tmp_path, fresh):
    _, cfg, laser, _, ticks = small
    fleet = ht.FleetSession(cfg, laser, ROBOTS, device="cpu")
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
        for name in ("hs.fleet.convert", "hs.graph:fleet_step_jit",
                     "hs.fleet.read"):
            [parts[name]] = [s for s in spans
                             if s[0] == name and _inside(s, root)]
        # conversion, then the graph call, then the read
        conv, call, read = parts.values()
        assert conv[1] + conv[2] <= call[1]
        assert call[1] + call[2] <= read[1]
    # the first tick captured (left out of the root's time), the traced
    # ticks are left out of every time
    c = tracing.counters()
    assert c["fleet.step"] == 4 and c["fleet.step.timed"] == 0
    assert c["fleet.convert.timed"] == c["fleet.read.timed"] == 1


def test_counters_count_robot_steps_and_read_gates(small, fresh):
    _, cfg, laser, _, ticks = small
    fleet, _, gates = _run_fleet(cfg, laser, ticks[:12])
    c = tracing.counters()
    assert c["fleet.robot_steps"] == 12 * ROBOTS
    assert c["fleet.gated"] == int(gates.sum()) == int(
        fleet.state.map_update_count.sum())
    for name in ("fleet.step", "fleet.convert", "fleet.read"):
        assert c[name] == c[name + ".timed"] == 12 and c[name + ".ns"] > 0
    assert c["fleet.convert.ns"] + c["fleet.read.ns"] <= c["fleet.step.ns"]


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
    assert entry[0]["moves"] == "scan_p95_ms"


@pytest.mark.parametrize("name", [n for n in READERS
                                  if n.startswith("fleet.")
                                  and n != "fleet.device_ms_per_step"
                                  and n != "fleet.host_ms_per_step"])
def test_counter_reader_reads_a_fleet_run(small, name, fresh):
    from benchmark.harness import core, spec, trace
    _, cfg, laser, _, ticks = small
    _run_fleet(cfg, laser, ticks[:6])
    run = core.Run(spec.find_cell(CELL), 0, 0.0, trace.Tracer(False), 0.0,
                   device="cpu")
    value = spec.metric_reader(name).read(run)
    assert value is not None and math.isfinite(value) and value > 0


# ---- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_fleet_session_bit_equal_to_eager_fleet_step_on_card():
    """The served path at the cell's size: 8 robots x 2048^2 x 2 through
    ``FleetSession`` (the captured ``fleet_step_jit``) against the eager
    ``fleet_step`` on the same conversions, and robots 0 and 7 against
    their own ``SlamSession``s, bit for bit, over 60 ticks."""
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
    fleet = ht.FleetSession(cfg, laser, robots, device=dev)
    eager = ht.init_fleet(cfg, robots, dev)
    dirs = beam_directions(laser, ticks.shape[2], dev)
    solos = {r: ht.SlamSession(cfg, laser, device=dev) for r in (0, 7)}
    fired = 0
    for t, rows in enumerate(ticks):
        poses = fleet.process_ranges(rows)
        scans = scans_from_ranges(torch.from_numpy(rows).to(dev), dirs,
                                  cfg.map.level_scale(0), laser,
                                  cfg.max_beams)
        for r in (0, 7):
            one = ht.scan_from_ranges(rows[r], cfg.map.level_scale(0),
                                      laser, cfg.max_beams, device=dev)
            assert torch.equal(_bits(scans.points[r]), _bits(one.points))
            assert torch.equal(scans.mask[r], one.mask)
        eager, metrics = ht.fleet_step(eager, scans, cfg)
        assert np.array_equal(poses.view(np.int32),
                              eager.pose.cpu().numpy().view(np.int32)), t
        assert np.array_equal(fleet.gates, metrics.map_updated.cpu()
                              .numpy()), t
        fired += int(fleet.gates.sum())
        for r, solo in solos.items():
            pose = solo.process_ranges(rows[r])
            assert np.array_equal(pose.view(np.int32),
                                  poses[r].view(np.int32)), (t, r)
    assert fired > robots
    for a, b in zip(fleet.state.log_odds + fleet.state.quads,
                    eager.log_odds + eager.quads):
        assert torch.equal(_bits(a), _bits(b))
    for r, solo in solos.items():
        for a, b in zip(solo.state.log_odds + solo.state.quads,
                        fleet.state.log_odds + fleet.state.quads):
            assert torch.equal(_bits(a), _bits(b[r])), r
    [entry] = [g for g in graphs.stats() if g.name == "fleet_step_jit"]
    assert entry.replays == 60
    graphs.clear()
