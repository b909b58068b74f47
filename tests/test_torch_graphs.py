"""The step bodies on the CPU (the bodies the CUDA graphs of
core/graphs.py capture on the card): the donating and the copying form,
held to JAX, and free of host reads.

  - ``slam_step(in_place=True)`` over the first 60 scans of the corridor
    fixture at ``BENCH_CONFIG`` (the map update on every scan, the gate a
    device select): poses, every metric, every state leaf and the final
    maps bit-equal to ``in_place=False``, which leaves its input state as
    it was; ``run_log_jit``'s gates equal to JAX's ``run_log_jit`` and
    pose RMSE < 5 mm (the sequential bar of tests/test_torch_slam.py);
  - the segment-compacted update, its fallback decided on the device:
    within and past the budget (``budget_segments=4`` forces the dense
    fallback) its cells are JAX's ``rasterize_scan_seg``'s and the dense
    layout's, and ``slam_step(raster_backend="seg")`` is bit-equal to
    ``slam_step(raster_backend="xla")`` over scans gated and not;
  - no host round trip: each body runs with ``Tensor.__bool__``, ``item``,
    ``tolist``, ``cpu``, ``numpy``, ``__int__``, ``__float__`` and
    ``torch.tensor`` patched to raise (after one unpatched call, as the
    graphs' warm-up, which puts the transforms' constants on the device);
    a step whose caller reads its gate on the host is the control that
    trips it;
  - the graph helpers that run without a card: the donated write-back
    with aliased leaves, fresh copies of outputs, device constants;
  - the session's "step" and "phases" modes through the ``_jit`` entry
    points.
Fleets and the batched matchers: tests/test_torch_graphs_fleets.py."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hector_slam_tpu.config import BENCH_CONFIG as JCFG
from hector_slam_tpu.core import mapping as jmap
from hector_slam_tpu.core.slam import init_state as j_init
from hector_slam_tpu.core.slam import run_log_jit as j_run_log_jit
from hector_slam_tpu.io.scanlog import load_log as j_load_log
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.io.scanlog import stack_scans as j_stack

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import graphs
from hector_slam_tpu_torch.core import mapping as tmap
from hector_slam_tpu_torch.core.grid import (device_constant, map_to_world,
                                             world_to_map)
from hector_slam_tpu_torch.core.slam import match_phase, update_phase
from tools.make_torch_reference import FIXTURE

SCANS = 60
SEG_SCANS = 24
RMSE_BUDGET_M = 0.005
HOST_READS = ("__bool__", "item", "tolist", "cpu", "numpy", "__int__",
              "__float__")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def no_host_reads():
    """Every way a body could read device data on the host (or copy a
    host value to the device) raises inside the block."""
    def refuse(*args, **kwargs):
        raise AssertionError("a host round trip in a step body")

    with pytest.MonkeyPatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse)
        mp.setattr(torch, "tensor", refuse)
        yield


@pytest.fixture(scope="module")
def fixture_log():
    ranges, laser, _ = ht.load_log(FIXTURE)
    cfg = ht.BENCH_CONFIG
    return ranges[:SCANS], laser, ht.stack_scans([ht.scan_from_ranges(
        r, cfg.map.level_scale(0), laser, cfg.max_beams, device="cpu")
        for r in ranges[:SCANS]])


@pytest.fixture(scope="module")
def replays(fixture_log):
    cfg = ht.BENCH_CONFIG
    _, _, scans = fixture_log
    return ht.run_log_jit(ht.init_state(cfg, device="cpu"), scans, cfg)


def _equal_states(a, b):
    for x, y in zip(a.log_odds + a.quads, b.log_odds + b.quads):
        assert torch.equal(x, y)
    for f in ("pose", "last_map_update_pose", "covariance", "step",
              "map_update_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_donating_step_is_bit_equal_to_copying_step(fixture_log):
    """``in_place=True`` (the donating step that the graphs capture)
    writes the new maps into the state's own levels and quads;
    ``in_place=False`` writes copies and leaves its input as it was
    (``integrate_sets``' two branches). Both give the same steps."""
    cfg = ht.BENCH_CONFIG
    _, _, scans = fixture_log
    a = ht.init_state(cfg, device="cpu")
    b = ht.init_state(cfg, device="cpu")
    gates = []
    for t in range(SCANS):
        sc = ht.Scan(scans.points[t], scans.origo[t], scans.mask[t])
        prev, kept = a, graphs.fresh(a)
        a, ma = ht.slam_step(prev, sc, cfg)
        _equal_states(prev, kept)
        maps = [x.data_ptr() for x in b.log_odds + b.quads]
        b, mb = ht.slam_step(b, sc, cfg, in_place=True)
        assert [x.data_ptr() for x in b.log_odds + b.quads] == maps
        for x, y in zip(ma, mb):
            assert x.dtype == y.dtype and torch.equal(x, y)
        _equal_states(a, b)
        gates.append(bool(ma.map_updated))
    # the update ran on every scan, the gate kept the map on most
    assert 3 < sum(gates) < SCANS // 2
    assert int(b.map_update_count) == sum(gates)
    assert int(b.step) == SCANS


def test_run_log_jit_body_holds_to_jax(fixture_log, replays):
    ranges, _, _ = fixture_log
    _, jlaser, _ = j_load_log(FIXTURE)
    scans = j_stack([j_scan(r, JCFG.map.level_scale(0), jlaser,
                            JCFG.max_beams) for r in ranges])
    jstate, jposes, jmetrics = j_run_log_jit(j_init(JCFG), scans, JCFG)
    state, poses, metrics = replays
    np.testing.assert_array_equal(metrics.map_updated.numpy(),
                                  np.asarray(jmetrics.map_updated))
    rmse = float(np.sqrt(np.mean((poses.numpy()[:, :2]
                                  - np.asarray(jposes)[:, :2]) ** 2)))
    assert rmse < RMSE_BUDGET_M
    assert int(state.map_update_count) == int(jstate.map_update_count)


def test_run_log_jit_empty_log_returns_what_run_log_returns():
    cfg = ht.SlamConfig(map=ht.MapConfig(size_x=64, size_y=64, levels=2))
    state = ht.init_state(cfg, device="cpu")
    empty = ht.Scan(torch.zeros((0, 8, 2)), torch.zeros((0, 2)),
                    torch.zeros((0, 8), dtype=torch.bool))
    got, poses, metrics = ht.run_log_jit(state, empty, cfg)
    want = ht.run_log(state, empty, cfg)
    assert got is state and poses.shape == (0, 3)
    for a, b in zip(metrics, want[2]):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("budget", [0, 4])   # 4 forces the dense fallback
def test_seg_fallback_decided_on_device_paints_jax_cells(fixture_log,
                                                         budget):
    """One BENCH_CONFIG update per level at the fixture's scans: the
    device-chosen sets paint JAX's ``rasterize_scan_seg`` cells with the
    same budget, and the dense layout's."""
    ranges, _, scans = fixture_log
    cfg = ht.BENCH_CONFIG
    _, jlaser, _ = j_load_log(FIXTURE)
    rng = np.random.default_rng(5)
    for t in (0, SCANS - 1):
        js = j_scan(ranges[t], JCFG.map.level_scale(0), jlaser,
                    JCFG.max_beams)
        pose = rng.normal(0, [0.05, 0.05, 0.02]).astype(np.float32)
        for level in range(cfg.map.levels):
            sx, sy = cfg.map.level_size(level)
            scale = 1.0 / 2 ** level
            common = (cfg.map.top_left_offset, cfg.map.level_scale(level),
                      cfg.level_max_ray_cells(level))
            targs = ((sy, sx), torch.from_numpy(pose),
                     scans.points[t] * scale if level else scans.points[t],
                     scans.origo[t] * scale if level else scans.origo[t],
                     scans.mask[t]) + common
            jargs = ((sy, sx), jnp.asarray(pose),
                     js.points * scale if level else js.points,
                     js.origo * scale if level else js.origo,
                     js.mask) + common
            free, occ, trunc = tmap.rasterize_scan_seg(
                *targs, budget_segments=budget)
            dense = tmap.rasterize_scan(*targs)
            jfree, jocc, jtrunc = jmap.rasterize_scan_seg(
                *jargs, budget_segments=budget)
            np.testing.assert_array_equal(free.numpy(), np.asarray(jfree))
            np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
            assert int(trunc) == int(jtrunc)
            for a, b in zip((free, occ, trunc), dense):
                assert torch.equal(a, b)
            assert free.any()
            *_, total, cap = tmap.seg_cell_indices(
                *targs, budget_segments=budget)
            assert (int(total) > cap) == (budget == 4)


@pytest.mark.parametrize("budget", [0, 4])
def test_seg_step_decided_on_device_is_bit_equal(monkeypatch, fixture_log,
                                                 budget):
    """``slam_step`` with the compacted sets (the card's default layout),
    within the budget and past it (4 segments: every level takes its
    dense fallback, chosen on the device), bit-equal to ``slam_step``
    with the dense sets ("xla"), over scans gated and not."""
    _, _, scans = fixture_log
    cfg = ht.BENCH_CONFIG
    if budget:
        seg_budget = tmap.seg_budget
        monkeypatch.setattr(tmap, "seg_budget", lambda n, k, b=0: seg_budget(
            n, k, budget))
    a = b = ht.init_state(cfg, device="cpu")
    gates = []
    for t in range(SEG_SCANS):
        sc = ht.Scan(scans.points[t], scans.origo[t], scans.mask[t])
        a, ma = ht.slam_step(a, sc, cfg, raster_backend="seg")
        b, mb = ht.slam_step(b, sc, cfg, raster_backend="xla")
        for x, y in zip(ma, mb):
            assert torch.equal(x, y)
        gates.append(bool(ma.map_updated))
    _equal_states(a, b)
    assert 1 < sum(gates) < SEG_SCANS


def test_step_bodies_make_no_host_round_trip(fixture_log):
    cfg = ht.BENCH_CONFIG
    _, _, scans = fixture_log
    state = ht.init_state(cfg, device="cpu")
    sc = ht.Scan(scans.points[0], scans.origo[0], scans.mask[0])
    hint = torch.tensor([0.01, -0.02, 0.003])
    short = ht.Scan(*(f[:2] for f in scans))

    def bodies():
        yield ht.slam_step(state, sc, cfg)
        yield ht.slam_step(state, sc, cfg, hint)
        yield ht.slam_step(state, sc, cfg, raster_backend="seg")
        yield ht.slam_step(state, sc, cfg, hint, True)
        pose, hess = match_phase(state, sc, cfg)
        yield update_phase(state, sc, cfg, pose, hess)
        yield ht.run_log_jit(state, short, cfg)
        yield ht.slam_step_jit(state, sc, cfg)
        for k in (0, 4):
            yield tmap.rasterize_scan_seg(
                (1024, 1024), hint, sc.points, sc.origo, sc.mask,
                cfg.map.top_left_offset, cfg.map.level_scale(0),
                cfg.level_max_ray_cells(0), budget_segments=k)

    warm = list(bodies())
    with no_host_reads():
        again = list(bodies())
    assert len(again) == len(warm) == 9
    # the control: a caller that reads the step's gate on the host
    with pytest.raises(AssertionError, match="host round trip"):
        with no_host_reads():
            bool(ht.slam_step(state, sc, cfg)[1].map_updated)


def test_write_back_copies_aliased_sources_first():
    """A donated leaf written before another leaf reads it would be read
    changed: ``graphs.write_back`` copies such a source aside first."""
    a, b, c = (torch.full((3,), float(v)) for v in (1, 2, 3))
    keep = a
    graphs.write_back([a, b, c], [b, a, c])   # swap a and b, keep c
    assert keep is a
    assert a.tolist() == [2.0] * 3 and b.tolist() == [1.0] * 3
    assert c.tolist() == [3.0] * 3


def test_fresh_copies_every_output_and_keeps_named_tuples():
    m = ht.StepMetrics(*(torch.zeros(()) for _ in range(5)))
    got = graphs.fresh((m, [1]))
    assert isinstance(got[0], ht.StepMetrics) and got[1] == [1]
    for x, y in zip(got[0], m):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()


def test_transform_constants_stay_on_the_device():
    """``world_to_map`` / ``map_to_world`` add a constant made once per
    (values, device), with the f32 values the host composes."""
    cfg = ht.BENCH_CONFIG.map
    xy = torch.tensor([[1.25, -3.5], [0.1, 0.2]])
    s = np.float32(cfg.level_scale(0))
    off = np.asarray(cfg.top_left_offset, np.float32) * s
    want = xy * float(s) + torch.from_numpy(off)
    assert torch.equal(world_to_map(xy, cfg.top_left_offset, s), want)
    c1 = device_constant(off, xy.device)
    assert device_constant(off.copy(), xy.device) is c1
    back = map_to_world(want, cfg.top_left_offset, cfg.resolution)
    assert torch.allclose(back, xy, atol=1e-5)
    with no_host_reads():
        world_to_map(xy, cfg.top_left_offset, s)


@pytest.mark.parametrize("mode", ["step", "phases"])
def test_session_runs_the_compiled_steps(monkeypatch, fixture_log, mode):
    """``SlamSession.process_ranges`` goes through ``slam_step_jit``, or
    ``match_phase_jit`` and ``update_phase_jit`` in "phases" mode, and
    its poses are ``run_log``'s bit for bit."""
    import hector_slam_tpu_torch.session as session_mod
    ranges, laser, _ = fixture_log
    calls = []
    for name in ("slam_step_jit", "match_phase_jit", "update_phase_jit"):
        fn = getattr(session_mod, name)
        monkeypatch.setattr(session_mod, name,
                            lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    cfg = ht.BENCH_CONFIG
    n = 12
    sess = ht.SlamSession(cfg, laser, timing_mode=mode, device="cpu")
    poses = np.stack([sess.process_ranges(r) for r in ranges[:n]])
    scans = ht.stack_scans([ht.scan_from_ranges(
        r, cfg.map.level_scale(0), laser, cfg.max_beams, device="cpu")
        for r in ranges[:n]])
    want = ht.run_log(ht.init_state(cfg, device="cpu"), scans, cfg)[1]
    np.testing.assert_array_equal(poses, want.numpy())
    expect = (["slam_step_jit"] if mode == "step"
              else ["match_phase_jit", "update_phase_jit"])
    assert calls == expect * n
