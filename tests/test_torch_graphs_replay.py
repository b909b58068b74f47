"""The compiled entry points' graph path (core/graphs.py: the cache and
its keys, the static buffers and their copy-in, the donated write-back,
run_log_jit's step counter on the device, the launch accounting) driven
on the CPU. A CUDA capture exists only on the card, so ``graphs._capture``
is replaced by a stand-in with a graph's semantics: the warm-up runs the
body without writing, the capture leaves every input as it was, and a
replay runs the captured body with writing and copies its results into
the capture's outputs, as a replay rewrites the same buffers.

Checked against the eager functions over many replays, bit for bit:
``slam_step_jit`` (with and without a pose hint, ``map_without_matching``),
the phase pair, ``run_log_jit``, ``fleet_step_jit``,
``shared_fleet_step_jit`` and both hypothesis matchers; the donation (the
maps written in place, a state passed back copies nothing, two states
keep two graphs and never see each other's steps, a state that shares
maps with a donated one changes with it); ``run_log_jit`` and the
matchers donate nothing; the cache keeps at most ``MAX_GRAPHS``."""

import numpy as np
import pytest
import torch

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import graphs
from hector_slam_tpu_torch.core.slam import match_phase_jit, update_phase_jit
from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                simulate_trajectory)
from tools.make_torch_reference import FIXTURE

SCANS = 16
# the fixture's scans shrunk 4x to fit a 128^2 map, and gate thresholds
# small enough that the map updates every few scans
CFG = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=128,
                                     size_y=128, levels=2),
                    max_ray_cells=128, map_update_distance_thresh=0.02,
                    map_update_angle_thresh=0.02)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _copy_tree(dst, src):
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for a, b in zip(dst, src):
            _copy_tree(a, b)


def _set_counts(counts):
    for name, kernel in graphs.COUNTED.items():
        kernel.launches = counts[name]


class ReplayedBody:
    """A captured graph's stand-in: each replay runs the body again and
    writes its results into the capture's outputs. A replay runs no
    Python on the card, so the kernel wrappers' counts of this run are
    taken back (``Entry.replay`` adds the capture's)."""

    def __init__(self, run, outputs):
        self.run = run
        self.outputs = outputs

    def replay(self):
        counts = graphs._counts()
        _copy_tree(self.outputs, self.run())
        _set_counts(counts)


def capture_on_cpu(name, held, copied, body):
    statics = [t.clone() for t in copied]
    before = graphs._counts()
    body(held, statics, False)
    warmup = {k: n - before[k] for k, n in graphs._counts().items()}
    inputs = list(held) + statics
    snapshot = [t.clone() for t in inputs]
    before = graphs._counts()
    outputs = body(held, statics, True)
    per_replay = {k: n - before[k] for k, n in graphs._counts().items()}
    _set_counts(before)
    for t, s in zip(inputs, snapshot):   # a capture runs nothing
        t.copy_(s)
    graphs._TOTALS["captures"] += 1
    for k, n in warmup.items():
        graphs._TOTALS["launches"][k] += n
    return graphs.Entry(name, ReplayedBody(lambda: body(held, statics, True),
                                           outputs),
                        list(held), statics, outputs, per_replay, warmup, 0)


@pytest.fixture
def as_on_card(monkeypatch):
    """The entry points take their card path on CPU tensors."""
    monkeypatch.setattr(graphs, "on_card", lambda t: True)
    monkeypatch.setattr(graphs, "_capture", capture_on_cpu)
    graphs.clear()
    yield
    graphs.clear()


@pytest.fixture(scope="module")
def log():
    ranges, laser, _ = ht.load_log(FIXTURE)
    scans = ht.stack_scans([ht.scan_from_ranges(
        r, CFG.map.level_scale(0) / 4, laser, CFG.max_beams, device="cpu")
        for r in ranges[:SCANS]])
    return scans, [ht.Scan(scans.points[t], scans.origo[t], scans.mask[t])
                   for t in range(SCANS)]


def _leaves(state):
    return [*state.log_odds, *state.quads, state.pose,
            state.last_map_update_pose, state.covariance, state.step,
            state.map_update_count]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def test_slam_step_jit_replays_donate_and_equal_slam_step(as_on_card, log):
    _, scans = log
    eager = ht.init_state(CFG, device="cpu")
    state = ht.init_state(CFG, device="cpu")
    maps = [t.data_ptr() for t in state.log_odds + state.quads]
    gates = []
    for t, sc in enumerate(scans):
        eager, me = ht.slam_step(eager, sc, CFG)
        before = state
        state, m = ht.slam_step_jit(state, sc, CFG)
        assert all(torch.equal(a, b) for a, b in zip(me, m))
        assert _same(eager, state)
        # the maps are the caller's, written in place; from the second
        # step on the state passed in is the graph's own
        assert [x.data_ptr() for x in state.log_odds + state.quads] == maps
        if t:
            assert all(x is y for x, y in zip(_leaves(before),
                                               _leaves(state)))
        gates.append(bool(me.map_updated))
    assert 1 < sum(gates) < SCANS
    [stats] = graphs.stats()
    assert stats.name == "slam_step_jit" and stats.replays == SCANS


def test_two_states_keep_their_own_graphs(as_on_card, log):
    """Two sessions' states step in turns: each keys its own graph (their
    maps differ), so neither sees the other's steps; a state sharing the
    maps of a donated one sees its map updates (donation)."""
    _, scans = log
    a = ht.init_state(CFG, device="cpu")
    b = ht.init_state(CFG, device="cpu")
    ea = eb = ht.init_state(CFG, device="cpu")
    for sc in scans[:8]:
        a, _ = ht.slam_step_jit(a, sc, CFG)
        ea, _ = ht.slam_step(ea, sc, CFG)
    alias = a._replace(pose=a.pose.clone())
    for sc in scans[8:]:
        b, _ = ht.slam_step_jit(b, sc, CFG)
        eb, _ = ht.slam_step(eb, sc, CFG)
        a, _ = ht.slam_step_jit(a, sc, CFG)
        ea, _ = ht.slam_step(ea, sc, CFG)
    assert _same(a, ea) and _same(b, eb)
    assert len(graphs.stats()) == 2
    assert alias.log_odds[0] is a.log_odds[0]


@pytest.mark.parametrize("hint,known", [(False, False), (True, False),
                                        (True, True)])
def test_hint_and_known_poses_equal_slam_step(as_on_card, log, hint, known):
    _, scans = log
    rng = np.random.default_rng(3)
    eager = state = ht.init_state(CFG, device="cpu")
    for sc in scans[:8]:
        h = (torch.from_numpy(rng.normal(0, 0.02, 3).astype(np.float32))
             + eager.pose) if hint else None
        eager, me = ht.slam_step(eager, sc, CFG, h, known)
        state, m = ht.slam_step_jit(state, sc, CFG, h, known)
        assert all(torch.equal(a, b) for a, b in zip(me, m))
        assert _same(eager, state)


def test_phase_pair_equals_slam_step(as_on_card, log):
    _, scans = log
    eager = state = ht.init_state(CFG, device="cpu")
    for sc in scans:
        eager, me = ht.slam_step(eager, sc, CFG)
        pose, hess = match_phase_jit(state, sc, CFG)
        state, m = update_phase_jit(state, sc, CFG, pose, hess)
        assert all(torch.equal(a, b) for a, b in zip(me, m))
        assert _same(eager, state)
    assert sorted(g.name for g in graphs.stats()) == [
        "match_phase_jit", "update_phase_jit"]


def test_run_log_jit_replays_equal_run_log_and_donate_nothing(as_on_card,
                                                              log):
    scans, _ = log
    start = ht.init_state(CFG, device="cpu")
    kept = graphs.fresh(start)
    want = ht.run_log(ht.init_state(CFG, device="cpu"), scans, CFG)
    for _ in range(2):     # the second call replays the same graph
        got = ht.run_log_jit(start, scans, CFG)
        assert _same(got[0], want[0]) and torch.equal(got[1], want[1])
        assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
        assert _same(start, kept)
    [stats] = graphs.stats()
    assert stats.replays == 2 * SCANS


@pytest.fixture(scope="module")
def fleet_scans():
    world = World.room(size=5.0)
    robots, steps = 3, 5
    ranges = []
    for r in range(robots):
        poses = corridor_trajectory(steps, advance=0.1 * r, weave=0.0)
        poses[:, 1] += 0.5 * r - 0.5
        ranges.append(simulate_trajectory(world, poses, ht.LaserModel(),
                                          seed=r))
    return [ht.stack_scans([ht.scan_from_ranges(
        ranges[r][t], CFG.map.level_scale(0), ht.LaserModel(),
        CFG.max_beams, device="cpu") for r in range(robots)])
        for t in range(steps)]


def test_fleet_graphs_equal_the_eager_fleets(as_on_card, fleet_scans):
    robots = fleet_scans[0].points.shape[0]
    fe = fj = ht.init_fleet(CFG, robots, device="cpu")
    starts = np.zeros((robots, 3), np.float32)
    se = sj = ht.init_shared_fleet(CFG, robots, start_poses=starts,
                                   device="cpu")
    for sc in fleet_scans:
        fe, me = ht.fleet_step(fe, sc, CFG)
        fj, mj = ht.fleet_step_jit(fj, sc, CFG)
        assert all(torch.equal(a, b) for a, b in zip(me, mj))
        se, me = ht.shared_fleet_step(se, sc, CFG)
        sj, mj = ht.shared_fleet_step_jit(sj, sc, CFG)
        assert all(torch.equal(a, b) for a, b in zip(me, mj))
    assert _same(fe, fj) and _same(se, sj)


def test_matcher_graphs_equal_the_eager_matchers(as_on_card, log):
    _, scans = log
    state = ht.init_state(CFG, device="cpu")
    for sc in scans[:6]:
        state, _ = ht.slam_step(state, sc, CFG)
    hyp = state.pose + torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.03, (32, 3)).astype(np.float32))
    for _ in range(2):
        kept = hyp.clone()
        want = ht.match_hypotheses_kernel(state.log_odds, hyp, scans[6],
                                          CFG, quads=state.quads)
        got = ht.match_hypotheses_kernel_jit(state.log_odds, hyp, scans[6],
                                             CFG, quads=state.quads)
        assert all(torch.equal(a, b) for a, b in zip(want[0] + want[1],
                                                     got[0] + got[1]))
        plain = ht.match_hypotheses_jit(state.log_odds, hyp, scans[6], CFG)
        assert all(torch.equal(a, b) for a, b in zip(
            plain, ht.match_hypotheses(state.log_odds, hyp, scans[6], CFG)))
        assert torch.equal(kept, hyp)     # the hypotheses are not donated
        hyp = hyp + 0.01      # new values, the same graphs
    assert [g.replays for g in graphs.stats()] == [2, 2]


def test_cache_keeps_the_newest_graphs(as_on_card, log, monkeypatch):
    _, scans = log
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    states = [ht.init_state(CFG, device="cpu") for _ in range(3)]
    for st in states:
        ht.slam_step_jit(st, scans[0], CFG)
    assert len(graphs.stats()) == 2
    totals = graphs.totals()
    assert totals["captures"] >= 3 and totals["replays"] >= 3


def test_launch_counts_add_up_per_replay(as_on_card, log, monkeypatch):
    """With the paint, the map tail and the matcher's robot kernel counted
    as the card counts them (one raster_paint launch a call where the CPU
    paints its index sets with one call, two tail launches, one matcher
    launch a level), a step graph counts its warm-up once and one paint,
    two tail and one matcher launch a level a replay, and no paint_cells
    launch: the cell sets are painted on every scan, and the tail's
    launches run on every scan too (its blocks return where the gate did
    not fire)."""
    from hector_slam_tpu_torch.core import mapping, matcher
    from hector_slam_tpu_torch.ops.map_tail import map_tail
    from hector_slam_tpu_torch.ops.raster_paint import raster_paint
    from hector_slam_tpu_torch.ops.robot_match import robot_match_level
    paint, tail = mapping.paint_cell_sets, mapping.map_tail
    match = matcher.robot_match_level

    def counted(flats, sizes):
        raster_paint.launches += 1
        return paint(flats, sizes)

    def counted_tail(*args):
        map_tail.launches += 2
        return tail(*args)

    def counted_match(*args):
        robot_match_level.launches += 1
        return match(*args)

    monkeypatch.setattr(mapping, "paint_cell_sets", counted)
    monkeypatch.setattr(mapping, "map_tail", counted_tail)
    monkeypatch.setattr(matcher, "robot_match_level", counted_match)
    _, scans = log
    before, totals = raster_paint.launches, graphs.totals()
    tails, matches = map_tail.launches, robot_match_level.launches
    state = ht.init_state(CFG, device="cpu")
    for sc in scans[:5]:
        state, _ = ht.slam_step_jit(state, sc, CFG)
    [stats] = graphs.stats()
    levels = CFG.map.levels
    assert stats.per_replay["raster_paint"] == stats.warmup["raster_paint"] \
        == 1
    assert stats.per_replay["paint_cells"] == stats.warmup["paint_cells"] \
        == 0
    assert stats.per_replay["map_tail"] == stats.warmup["map_tail"] == 2
    assert stats.per_replay["robot_match_level"] == levels
    assert stats.warmup["robot_match_level"] == levels
    assert stats.per_replay["interp_moments_level"] == 0
    assert raster_paint.launches - before == 1 + 5
    assert map_tail.launches - tails == 2 * (1 + 5)
    assert robot_match_level.launches - matches == levels * (1 + 5)
    after = graphs.totals()
    for name, per_call in (("raster_paint", 1), ("paint_cells", 0),
                           ("map_tail", 2), ("robot_match_level", levels)):
        assert after["launches"][name] - totals["launches"][name] \
            == 6 * per_call
    assert after["replays"] - totals["replays"] == 5


def test_session_reset_keeps_the_step_graph(as_on_card, log):
    """``SlamSession.reset`` writes the fresh state into the donated
    state's tensors (the graph's own small leaves among them): the next
    scans replay the step graph with no new capture, bit-equal to a
    fresh session's on the graph path."""
    _, scans = log
    sess = ht.SlamSession(CFG, device="cpu")
    for sc in scans[:4]:
        sess.process_scan(sc)
    captures = graphs.totals()["captures"]
    for _ in range(3):
        sess.reset()
        fresh = ht.SlamSession(CFG, device="cpu")
        for sc in scans[:3]:
            np.testing.assert_array_equal(sess.process_scan(sc),
                                          fresh.process_scan(sc))
        # the fresh session's maps are new memory: its own graph, the
        # only capture since the last reset
        captures += 1
        assert graphs.totals()["captures"] == captures
        graphs._CACHE.popitem()
        assert _same(sess.state, fresh.state)
    [stats] = graphs.stats()
    assert stats.name == "slam_step_jit" and stats.replays == 4 + 3 * 3
