"""The port's segment-compacted map update (``raster_backend="seg"``) on
the CPU, against the JAX package's seg path and the port's dense path:

  - ``rasterize_scan_seg``: cell sets and truncation bit-equal to JAX's
    ``rasterize_scan_seg`` and to the port's ``rasterize_scan``, with the
    dense fallback forced (``budget_segments=4``) and truncation forced
    (``max_ray_cells=40``) (mirror of tests/test_mapping.py:200-233);
  - ``update_pyramid(raster_backend="seg")`` equal to "xla" and to JAX's
    seg update; the empty scan a no-op (mirror of :236-270);
  - one ``BENCH_CONFIG`` update of a fixture scan at its JAX reference
    pose: every level's sets equal to JAX's, the segment totals inside
    the budgets, so the compacted sets themselves are painted;
  - ``slam_step(raster_backend="seg")`` over the fixture's first scans
    against JAX's ``slam_step`` with the same backend, and bit-equal to
    the port's own "xla" replay;
  - the auto rule (``pick_raster_backend``) and the refusals.

Cell sets and maps are compared exactly: both paths compute the same
integer cells. Poses are held to the sequential bar of
tests/test_torch_slam.py (RMSE < 5 mm)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hector_slam_tpu.config import BENCH_CONFIG as JCFG
from hector_slam_tpu.config import MapConfig as JMapConfig
from hector_slam_tpu.config import SlamConfig as JSlamConfig
from hector_slam_tpu.core import mapping as jmap
from hector_slam_tpu.core.slam import init_state as j_init
from hector_slam_tpu.core.slam import slam_step as j_slam_step
from hector_slam_tpu.io.scanlog import LaserModel as JLaser
from hector_slam_tpu.io.scanlog import load_log as j_load_log
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.io.simulator import (World, corridor_trajectory,
                                          simulate_trajectory)
from hector_slam_tpu.types import Scan as JScan

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import mapping as tmap
from hector_slam_tpu_torch.core.matcher import level_points
from tools.make_torch_reference import FIXTURE, REFERENCE

LASER = JLaser(num_beams=271, angle_min=-2.356, angle_increment=4 * 0.004363,
               range_min=0.1, range_max=12.0)
SIZE = 256
SLAM_SCANS = 40        # fixture prefix replayed through slam_step
FIXTURE_SCAN = 200     # the full-width single update
BENCH_BUDGETS = (2112, 1440, 1440)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(levels):
    kw = dict(resolution=0.05, size_x=SIZE, size_y=SIZE, levels=levels)
    return (ht.SlamConfig(map=ht.MapConfig(**kw), max_ray_cells=256),
            JSlamConfig(map=JMapConfig(**kw), max_ray_cells=256))


def _port_scan(js):
    return ht.scan_from_numpy(np.asarray(js.points), np.asarray(js.origo),
                              np.asarray(js.mask), device="cpu")


@pytest.fixture(scope="module")
def corridor():
    """4 corridor poses and their 271-beam JAX scans."""
    _, jcfg = _cfgs(1)
    poses = corridor_trajectory(4, advance=0.06, weave=0.03)
    ranges = simulate_trajectory(World.corridor(length=8.0, width=3.0),
                                 poses, LASER)
    return poses, [j_scan(r, jcfg.map.level_scale(0), LASER, jcfg.max_beams)
                   for r in ranges]


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("k_cap", [256, 40])      # 40 forces truncation
@pytest.mark.parametrize("budget", [0, 4])        # 4 forces the fallback
def test_rasterize_seg_equals_jax_seg_and_dense(corridor, k_cap, budget):
    cfg, _ = _cfgs(1)
    poses, jscans = corridor
    for pose, js in zip(poses, jscans):
        sc = _port_scan(js)
        targs = ((SIZE, SIZE), torch.from_numpy(pose), sc.points, sc.origo,
                 sc.mask, cfg.map.top_left_offset, cfg.map.level_scale(0),
                 k_cap)
        jargs = ((SIZE, SIZE), jnp.asarray(pose), js.points, js.origo,
                 js.mask, cfg.map.top_left_offset, cfg.map.level_scale(0),
                 k_cap)
        f, o, t = tmap.rasterize_scan_seg(*targs, budget_segments=budget)
        jf, jo, jt = jmap.rasterize_scan_seg(*jargs, budget_segments=budget)
        df, do, dt = tmap.rasterize_scan(*targs)
        _eq(f, jf)
        _eq(o, jo)
        assert torch.equal(f, df) and torch.equal(o, do)
        assert int(t) == int(jt) == int(dt)
        assert f.any() and o.any()
        # the route taken: compacted inside the default budget, the dense
        # fallback past budget 4
        *_, total, cap = tmap.seg_cell_indices(*targs, budget_segments=budget)
        assert (int(total) > cap) == (budget == 4)
    if k_cap == 40:
        assert int(t) > 0


def test_update_pyramid_seg_equals_xla_and_jax(corridor):
    cfg, jcfg = _cfgs(2)
    poses, jscans = corridor
    pose, js = poses[0], jscans[0]
    sc = _port_scan(js)
    state = ht.init_state(cfg, device="cpu")
    tpose = torch.from_numpy(pose)
    seg, tseg = tmap.update_pyramid(state.log_odds, tpose, sc, cfg,
                                    raster_backend="seg")
    dense, tdense = tmap.update_pyramid(state.log_odds, tpose, sc, cfg,
                                        raster_backend="xla")
    jlevels, jt = jmap.update_pyramid(j_init(jcfg).log_odds,
                                      jnp.asarray(pose), js, jcfg,
                                      raster_backend="seg")
    for a, b, j, lo in zip(seg, dense, jlevels, state.log_odds):
        assert torch.equal(a, b)
        _eq(a, j)
        assert (a != lo).any()
    assert int(tseg) == int(tdense) == int(jt)

    empty = ht.Scan(points=torch.zeros_like(sc.points), origo=sc.origo,
                    mask=torch.zeros_like(sc.mask))
    same, t0 = tmap.update_pyramid(state.log_odds, tpose, empty, cfg,
                                   raster_backend="seg")
    for a, lo in zip(same, state.log_odds):
        assert torch.equal(a, lo)
    assert int(t0) == 0


@pytest.fixture(scope="module")
def fixture_scans():
    """The fixture's JAX scans at BENCH_CONFIG and JAX's reference poses."""
    ranges, laser, _ = j_load_log(FIXTURE)
    scans = [j_scan(r, JCFG.map.level_scale(0), laser, JCFG.max_beams)
             for r in ranges[:max(SLAM_SCANS, FIXTURE_SCAN + 1)]]
    with np.load(REFERENCE) as ref:
        return scans, ref["poses"]


def test_bench_update_paints_seg_sets_equal_to_jax(fixture_scans):
    """Fixture scan 200 at its JAX reference pose on the full 1024^2 x 3
    BENCH_CONFIG: each level's compacted set fits its budget (so no
    fallback) and paints JAX's cells."""
    cfg = ht.BENCH_CONFIG
    scans, poses = fixture_scans
    js, pose = scans[FIXTURE_SCAN], poses[FIXTURE_SCAN]
    sc = _port_scan(js)
    for level in range(cfg.map.levels):
        sx, sy = cfg.map.level_size(level)
        targs = ((sy, sx), torch.from_numpy(pose),
                 level_points(sc.points, level),
                 level_points(sc.origo, level), sc.mask,
                 cfg.map.top_left_offset, cfg.map.level_scale(level),
                 cfg.level_max_ray_cells(level))
        factor = jnp.float32(1.0 / (2.0 ** level))
        jargs = ((sy, sx), jnp.asarray(pose),
                 js.points * factor if level else js.points,
                 js.origo * factor if level else js.origo, js.mask,
                 JCFG.map.top_left_offset, JCFG.map.level_scale(level),
                 JCFG.level_max_ray_cells(level))
        free, occ, _, _, total, budget = tmap.seg_cell_indices(*targs)
        assert budget == BENCH_BUDGETS[level]
        assert 0 < int(total) < budget
        assert tuple(free.shape) == (budget, 64)
        f, o, t = tmap.rasterize_scan_seg(*targs)
        jf, jo, jt = jmap.rasterize_scan_seg(*jargs)
        _eq(f, jf)
        _eq(o, jo)
        assert int(t) == int(jt) == 0
        assert int(f.sum()) > 500


def test_slam_step_seg_equals_jax_seg_and_port_xla(fixture_scans):
    """The first SLAM_SCANS fixture scans through slam_step with the seg
    backend: gates and maps equal to JAX's slam_step with the seg
    backend, poses within 5 mm RMSE, and every output bit-equal to the
    port's "xla" replay."""
    cfg = ht.BENCH_CONFIG
    jscans = fixture_scans[0][:SLAM_SCANS]
    jstep = jax.jit(functools.partial(j_slam_step, cfg=JCFG,
                                      raster_backend="seg"))
    jstate, jgates, jposes = j_init(JCFG), [], []
    for js in jscans:
        jstate, jm = jstep(jstate, JScan(js.points, js.origo, js.mask))
        jgates.append(bool(jm.map_updated))
        jposes.append(np.asarray(jstate.pose))

    runs = {}
    for backend in ("seg", "xla"):
        state, gates, poses, trunc = ht.init_state(cfg, device="cpu"), [], \
            [], 0
        for js in jscans:
            state, m = ht.slam_step(state, _port_scan(js), cfg,
                                    raster_backend=backend)
            gates.append(bool(m.map_updated))
            poses.append(state.pose.numpy())
            trunc += int(m.truncated_free_cells)
        runs[backend] = (state, gates, np.stack(poses), trunc)

    state, gates, poses, trunc = runs["seg"]
    assert gates == jgates and sum(gates) > 3
    assert trunc == 0
    rmse = float(np.sqrt(np.mean((poses[:, :2]
                                  - np.stack(jposes)[:, :2]) ** 2)))
    assert rmse < 0.005, rmse
    for lo, jlo in zip(state.log_odds, jstate.log_odds):
        _eq(lo, jlo)
    xstate, xgates, xposes, xtrunc = runs["xla"]
    assert xgates == gates and xtrunc == trunc
    np.testing.assert_array_equal(xposes, poses)
    for a, b in zip(state.log_odds, xstate.log_odds):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend,device,beam_axis,one_scan,want", [
    (None, "cpu", None, True, "xla"),
    (None, "cuda", None, True, "seg"),
    (None, "cuda", "group", True, "xla"),
    (None, "cuda", None, False, "xla"),
    ("xla", "cuda", None, True, "xla"),
    ("seg", "cpu", None, True, "seg"),
    ("seg", "cuda", "group", True, "seg"),
    ("xla", "cpu", None, False, "xla"),
])
def test_auto_rule_picks_jax_backend(backend, device, beam_axis, one_scan,
                                     want):
    """JAX's rule with the card as the accelerator: seg for one scan on a
    CUDA device without a beam axis; an explicit choice is kept (seg
    under a beam axis too: each rank compacts its own beams)."""
    assert tmap.pick_raster_backend(backend, torch.device(device), beam_axis,
                                    one_scan) == want


def test_seg_refuses_fleets_and_unknown_names(corridor):
    cfg, _ = _cfgs(1)
    poses, jscans = corridor
    with pytest.raises(ValueError, match="one scan"):
        tmap.pick_raster_backend("seg", torch.device("cuda"), None, False)
    with pytest.raises(ValueError, match="raster_backend"):
        tmap.pick_raster_backend("pallas", torch.device("cpu"))
    scans = ht.stack_scans([_port_scan(js) for js in jscans])
    tposes = torch.from_numpy(np.asarray(poses))
    state = ht.init_state(cfg, device="cpu")
    gates = torch.ones(len(poses), dtype=torch.bool)
    with pytest.raises(ValueError, match="one scan"):
        tmap.update_pyramid(state.log_odds, tposes, scans, cfg,
                            raster_backend="seg", gates=gates)
    level0 = state.log_odds[0]
    args = (tposes, scans.points, scans.origo, scans.mask,
            cfg.map.top_left_offset, cfg.map.level_scale(0), 256)
    with pytest.raises(ValueError, match="one scan"):
        tmap.update_level(level0, *args, cfg.update.log_odds_free,
                          cfg.update.log_odds_occupied,
                          raster_backend="seg")
    with pytest.raises(ValueError, match="one scan"):
        tmap.update_level(level0.expand(len(poses), *level0.shape), *args,
                          cfg.update.log_odds_free,
                          cfg.update.log_odds_occupied,
                          raster_backend="seg")
    with pytest.raises(ValueError, match="one scan"):
        tmap.rasterize_scan_seg((SIZE, SIZE), *args)
    with pytest.raises(ValueError, match="raster_backend"):
        tmap.update_pyramid(state.log_odds, tposes[0], ht.Scan(
            scans.points[0], scans.origo[0], scans.mask[0]), cfg,
            raster_backend="dense")


@pytest.mark.parametrize("backend,seg_sets", [(None, False), ("xla", False),
                                              ("seg", True)])
def test_slam_step_paints_the_picked_layout(monkeypatch, corridor, backend,
                                            seg_sets):
    """What slam_step paints: on the CPU the default is the dense layout
    ([N, K] free slots), "seg" the compacted one ([budget, 64] slots)
    followed by the dense one, the fallback chosen on the device: within
    the budget the compacted block holds the cells and the dense block
    only the sentinel."""
    cfg, _ = _cfgs(2)
    poses, jscans = corridor
    shapes, painted = [], []
    paint = tmap.paint_cell_sets

    def spy(flats, sizes):
        shapes.append([tuple(f.shape) for f in flats])
        painted.append((flats, sizes))
        return paint(flats, sizes)

    monkeypatch.setattr(tmap, "paint_cell_sets", spy)
    state = ht.init_state(cfg, device="cpu")
    state, m = ht.slam_step(state, _port_scan(jscans[0]), cfg,
                            pose_hint=torch.from_numpy(poses[0]),
                            map_without_matching=True,
                            raster_backend=backend)
    assert bool(m.map_updated)
    [sets] = shapes
    free_shapes = sets[0::2]
    n = cfg.max_beams
    if seg_sets:
        [(flats, sizes)] = painted
        for lv, (free, cells) in enumerate(zip(flats[0::2], sizes[0::2])):
            k = cfg.level_max_ray_cells(lv)
            slots = tmap.seg_budget(n, k)[1] * 64
            assert free_shapes[lv] == (slots + n * k,)
            compacted, dense = free[:slots], free[slots:]
            assert (compacted < cells).any() and (dense == cells).all()
    else:
        assert free_shapes == [(n, cfg.level_max_ray_cells(lv))
                               for lv in range(cfg.map.levels)]
    assert sets[1::2] == [(n,)] * cfg.map.levels
