"""The port's spans and counters (hector_slam_tpu_torch/tracing.py) on
the CPU: with no profiler recording nothing is created; under
``torch.profiler`` each scan is one ``hs.scan`` span holding its
conversion and its read; the counters count what ran, and leave traced
and capturing calls out of their host times; the graph cache counts
evictions and host times through its CPU stand-in
(``test_torch_graphs_replay.as_on_card``); the benchmark's readers of
these counters read a cut run.

The ``cuda`` tests check on the card what the CPU cannot show: a real
capture's counts, evictions, the replays' host times, the launch counts
of ``graphs.stats()``, and a replay span's place before its kernels in
the trace. Run them on a machine with a card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_tracing.py
"""

import json
import math
from collections import defaultdict

import numpy as np
import pytest
import torch

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch import tracing
from hector_slam_tpu_torch.core import graphs
from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                simulate_trajectory)
from test_torch_graphs_replay import as_on_card  # noqa: F401 (fixture)

# the harness's own span names (benchmark/drivers, benchmark/harness)
HARNESS_SPANS = {"bench.traced_window", "traffic.wait_due",
                 "traffic.wait_in_flight", "session.process_ranges",
                 "entry.match_hypotheses_kernel_jit", "copy.outputs"}
LASER = ht.LaserModel(num_beams=91, angle_min=-1.57, angle_increment=0.0349,
                      range_min=0.1, range_max=5.0)
CFG = ht.SlamConfig(map=ht.MapConfig(resolution=0.1, size_x=128,
                                     size_y=128, levels=2),
                    max_beams=128, max_ray_cells=64,
                    map_update_distance_thresh=0.1,
                    map_update_angle_thresh=0.05)
SCANS = 9
NEW_METRICS = ("session.convert_ms_per_scan", "session.read_ms_per_scan",
               "step.host_ms_per_scan", "update.gated_share",
               "match.host_ms_per_call", "graph.replay_host_ms",
               "graph.captures")
# finite on a CPU run: the session's timers and the update counts; the
# graph metrics read nothing there
ON_CPU = {"session.convert_ms_per_scan", "session.read_ms_per_scan",
          "update.gated_share"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class FreshCounters:
    """Every counter of ``tracing`` and ``graphs`` from zero, the
    process's own put back on exit."""

    def __enter__(self):
        self.saved = (tracing._COUNTS, tracing._TIMED, graphs._TOTALS)
        tracing._COUNTS = defaultdict(int)
        tracing._TIMED = {}
        graphs._TOTALS = {"captures": 0, "replays": 0,
                          "launches": {k: 0 for k in graphs.COUNTED}}

    def __exit__(self, *exc):
        tracing._COUNTS, tracing._TIMED, graphs._TOTALS = self.saved


@pytest.fixture
def fresh():
    with FreshCounters():
        yield


@pytest.fixture(scope="module")
def ranges():
    world = World.corridor(length=8.0, width=3.0)
    poses = corridor_trajectory(SCANS, advance=0.06, weave=0.03)
    return simulate_trajectory(world, poses, LASER)


def _session(device="cpu"):
    return ht.SlamSession(CFG, LASER, device=device)


def _profiled(fn, cuda=False):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return prof


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _spans(events):
    return [(e["name"], float(e["ts"]), float(e.get("dur", 0)))
            for e in events if e.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[1] + inner[2] <= outer[1] + \
        outer[2]


def test_no_record_function_without_a_profiler(monkeypatch, ranges, fresh):
    made = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        made.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    session = _session()
    for r in ranges:
        session.process_ranges(r)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert made == []
    assert tracing.counters()["session.scan"] == SCANS


def test_scans_under_a_profiler_hold_their_spans(ranges, tmp_path, fresh):
    session = _session()
    session.process_ranges(ranges[0])
    prof = _profiled(lambda: [session.process_ranges(r)
                              for r in ranges[1:4]])
    spans = _spans(_events(prof, tmp_path))
    names = {n for n, _, _ in spans}
    assert names >= {"hs.scan", "hs.convert", "hs.read"}
    assert all(n.startswith("hs.") for n in names)
    assert not names & HARNESS_SPANS
    roots = [s for s in spans if s[0] == "hs.scan"]
    assert len(roots) == 3
    for name in ("hs.convert", "hs.read"):
        children = [s for s in spans if s[0] == name]
        assert len(children) == 3
        assert all(sum(_inside(c, r) for c in children) == 1 for r in roots)


def test_counters_count_scans_updates_and_gates(ranges, fresh):
    session = _session()
    for r in ranges[:4]:
        session.process_ranges(r)
    _profiled(lambda: [session.process_ranges(r) for r in ranges[4:6]])
    for r in ranges[6:]:
        session.process_ranges(r)
    c = tracing.counters()
    for name in ("session.scan", "session.convert", "session.read"):
        assert c[name] == SCANS
        assert c[name + ".timed"] == SCANS - 2
        assert c[name + ".ns"] > 0
    # the CPU session runs the step body eagerly: one update body a
    # scan, and the session reads each scan's gate
    assert c["update.runs"] == SCANS
    assert c["update.gated"] == int(session.state.map_update_count)
    assert 0 < c["update.gated"] < SCANS
    # the session's own time of a scan runs from the conversion's end to
    # the read's end: with the conversion it lies inside the root, and
    # the read inside it (the untraced scans' sums)
    assert session.timing_stats()["count"] == SCANS
    own_ns = sum(session._scan_times_ms[:4] + session._scan_times_ms[6:]) \
        * 1e6
    assert c["session.read.ns"] <= own_ns + 1e3
    assert c["session.convert.ns"] + own_ns <= c["session.scan.ns"] + 1e3


def test_process_scan_and_points_are_roots(ranges, fresh):
    session = _session()
    scan = ht.scan_from_ranges(ranges[0], CFG.map.level_scale(0), LASER,
                               CFG.max_beams, device="cpu")
    session.process_scan(scan)
    ang = LASER.angle_min + LASER.angle_increment * np.arange(len(ranges[1]))
    pts = np.stack([np.cos(ang) * ranges[1], np.sin(ang) * ranges[1]], -1)
    session.process_points(pts)
    c = tracing.counters()
    assert c["session.scan"] == 2 and c["session.read"] == 2
    assert c["session.convert"] == 1
    session.pause()
    assert session.process_scan(scan) is None
    assert tracing.counters()["session.read"] == 2


def test_graph_uses_time_all_but_the_capture(as_on_card, ranges, fresh):
    state = ht.init_state(CFG, device="cpu")
    scans = [ht.scan_from_ranges(r, CFG.map.level_scale(0), LASER,
                                 CFG.max_beams, device="cpu")
             for r in ranges]
    for sc in scans:
        state, _ = ht.slam_step_jit(state, sc, CFG)
    t = graphs.totals()
    assert t["captures"] == 1 and t["evictions"] == 0
    assert t["entries"]["slam_step_jit"][:2] == [SCANS, SCANS - 1]
    assert t["entries"]["slam_step_jit"][2] > 0
    assert t["replay_host"][:2] == [SCANS, SCANS - 1]
    assert t["capture_ns"] > 0
    c = tracing.counters()
    assert c["graph.capture"] == 1 and c["graph.capture.timed"] == 1
    # the parts of a use lie inside it: lookup, replay, outputs
    assert c["graph.replay_host.ns"] < c["graph.host[slam_step_jit].ns"]


def test_cache_counts_its_evictions(as_on_card, fresh):
    x = torch.arange(4.0)
    for k in range(graphs.MAX_GRAPHS + 1):
        graphs.call("toy", (k,), [], [x], lambda held, st: st[0] * 2)
    assert graphs.totals()["evictions"] == 1
    assert len(graphs.stats()) == graphs.MAX_GRAPHS
    graphs.call("toy", (0,), [], [x], lambda held, st: st[0] * 2)
    t = graphs.totals()
    assert t["captures"] == graphs.MAX_GRAPHS + 2 and t["evictions"] == 2
    assert t["entries"]["toy"][:2] == [graphs.MAX_GRAPHS + 2, 0]
    graphs.clear()
    assert graphs.totals()["evictions"] == 2


def test_graph_spans_nest_in_their_use(as_on_card, ranges, tmp_path,
                                      fresh):
    state = ht.init_state(CFG, device="cpu")
    scans = [ht.scan_from_ranges(r, CFG.map.level_scale(0), LASER,
                                 CFG.max_beams, device="cpu")
             for r in ranges[:3]]

    def steps():
        st = state
        for sc in scans:
            st, _ = ht.slam_step_jit(st, sc, CFG)

    spans = _spans(_events(_profiled(steps), tmp_path))
    uses = [s for s in spans if s[0] == "hs.graph:slam_step_jit"]
    assert len(uses) == 3
    for name, n in (("hs.graph.lookup", 3), ("hs.graph.replay", 3),
                    ("hs.graph.outputs", 3), ("hs.graph.capture", 1)):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) >= n, name
        assert all(any(_inside(x, u) for u in uses) for x in inner), name
    [capture] = [s for s in spans if s[0] == "hs.graph.capture"]
    assert any(_inside(capture, s) for s in spans
               if s[0] == "hs.graph.lookup")
    assert _inside(capture, uses[0])
    # traced uses are counted, and none is timed
    t = graphs.totals()
    assert t["entries"]["slam_step_jit"] == [3, 0, 0]
    assert t["replay_host"] == [3, 0, 0]


@pytest.fixture(scope="module")
def tiny_readings():
    """The new readers over a cut run of each cell, counters from zero."""
    from benchmark.harness import spec
    from benchmark.tests import tiny
    out = {}
    for cell in tiny.CELLS:
        with FreshCounters():
            run = tiny.run_tiny(cell)
            for name in NEW_METRICS:
                out[cell, name] = spec.metric_reader(name).read(run)
    return out


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_reads_a_cut_run(tiny_readings, name):
    from benchmark.harness import spec
    entry = [m for m in json.loads((spec.ROOT / "BENCHMARK.json")
                                   .read_text())["per_layer"]
             if m["name"] == name]
    assert len(entry) == 1 and entry[0]["source"] == "program_counter"
    for cell in entry[0]["workloads"]:
        value = tiny_readings[cell, name]
        if name in ON_CPU:
            assert value is not None and math.isfinite(value), (cell, value)
        else:
            assert value is None, (cell, value)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


@pytest.mark.cuda
def test_card_evictions_and_replay_times(cuda_device, fresh):
    x = torch.arange(1024.0, device=cuda_device)
    for k in range(graphs.MAX_GRAPHS + 1):
        graphs.call("toy", (k,), [], [x], lambda held, st: st[0] * 2 + k)
    t = graphs.totals()
    assert t["captures"] == graphs.MAX_GRAPHS + 1 and t["evictions"] == 1
    assert t["replay_host"] == [graphs.MAX_GRAPHS + 1, 0, 0]
    last = t["replay_host"]
    for i in range(3):
        graphs.call("toy", (graphs.MAX_GRAPHS,), [], [x],
                    lambda held, st: st[0] * 2)
        now = graphs.totals()["replay_host"]
        assert now[:2] == [last[0] + 1, last[1] + 1] and now[2] > last[2]
        last = now
    graphs.call("toy", (0,), [], [x], lambda held, st: st[0] * 2)
    t = graphs.totals()
    assert t["evictions"] == 2 and t["replay_host"][1:] == last[1:]


@pytest.mark.cuda
def test_card_step_counts_launches_and_updates(cuda_device, ranges, fresh):
    scans = [ht.scan_from_ranges(r, CFG.map.level_scale(0), LASER,
                                 CFG.max_beams, device=cuda_device)
             for r in ranges]
    eager = ht.init_state(CFG, cuda_device)
    before = graphs._counts()
    eager, _ = ht.slam_step(eager, scans[0], CFG)
    one_step = {k: n - before[k] for k, n in graphs._counts().items()}
    runs0 = tracing.counters()["update.runs"]
    session = ht.SlamSession(CFG, LASER, device=cuda_device)
    for r in ranges:
        session.process_ranges(r)
    [entry] = [g for g in graphs.stats() if g.name == "slam_step_jit"]
    assert entry.per_replay == one_step and entry.replays == SCANS
    c = tracing.counters()
    # the capture's update is taken back and added at each replay; the
    # warm-up's ran
    assert c["update.runs"] - runs0 == SCANS + 1
    assert c["update.gated"] == int(session.state.map_update_count)
    # the scan that captured is left out of every time around the capture
    assert c["graph.host[slam_step_jit].timed"] == SCANS - 1
    assert c["session.scan.timed"] == SCANS - 1
    assert c["session.read.timed"] == c["session.convert.timed"] == SCANS


@pytest.mark.cuda
def test_card_replay_span_precedes_its_kernels(cuda_device, ranges,
                                               tmp_path, fresh):
    session = ht.SlamSession(CFG, LASER, device=cuda_device)
    session.process_ranges(ranges[0])
    torch.cuda.synchronize()
    prof = _profiled(lambda: [session.process_ranges(r)
                              for r in ranges[1:4]], cuda=True)
    events = _events(prof, tmp_path)
    spans = _spans(events)
    replays = [s for s in spans if s[0] == "hs.graph.replay"]
    assert len(replays) == 3
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "GraphLaunch" in e["name"]]
    assert len(launches) == 3
    kernels = defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["args"].get("correlation")].append(float(e["ts"]))
    for launch in launches:
        row = (launch["name"], float(launch["ts"]),
               float(launch.get("dur", 0)))
        [span] = [s for s in replays if _inside(row, s)]
        mine = kernels[launch["args"]["correlation"]]
        assert mine and span[1] < min(mine)
    for name in ("hs.scan", "hs.graph:slam_step_jit", "hs.graph.lookup",
                 "hs.graph.outputs", "hs.read", "hs.convert"):
        assert sum(s[0] == name for s in spans) >= 3, name
