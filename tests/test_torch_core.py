"""Parity of the PyTorch port's core math with the JAX package on the CPU:
presets, transforms, angle normalization, the gate predicate, solve3,
cell models, quad packing, interpolation and the map-update rasterizer.

Every input is made with numpy from a seed and handed to both packages.
Discrete decisions and pure f32 arithmetic are held BIT-EQUAL; the one
transcendental (exp in prob_grid) is held to a measured ulp gap."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hector_slam_tpu.config as jcfg
from hector_slam_tpu.core import cell_models as jcm
from hector_slam_tpu.core import grid as jgrid
from hector_slam_tpu.core import interp as jinterp
from hector_slam_tpu.core import mapping as jmap
from hector_slam_tpu.ops import solve3 as jsolve
from hector_slam_tpu.types import Scan as JScan

import hector_slam_tpu_torch.config as tcfg
from hector_slam_tpu_torch.core import cell_models as tcm
from hector_slam_tpu_torch.core import grid as tgrid
from hector_slam_tpu_torch.core import interp as tinterp
from hector_slam_tpu_torch.core import mapping as tmap
from hector_slam_tpu_torch.ops import solve3 as tsolve
from hector_slam_tpu_torch.types import Scan as TScan

PRESETS = ["BENCH_CONFIG", "CITYFLYER_LOG_CONFIG", "DEFAULT_CONFIG",
           "HEIGHT_MAPPING_CONFIG", "MAPPING_BOX_CONFIG", "PR2_CONFIG",
           "SINGLE_MAP_CONFIG", "TUTORIAL_CONFIG", "UGV_CONFIG"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def T(a):
    return torch.from_numpy(np.array(a))


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal(name):
    a, b = getattr(jcfg, name), getattr(tcfg, name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for lvl in range(a.map.levels):
        assert a.map.level_scale(lvl) == b.map.level_scale(lvl)
        assert a.map.level_resolution(lvl) == b.map.level_resolution(lvl)
        assert a.map.level_size(lvl) == b.map.level_size(lvl)
        assert a.level_max_ray_cells(lvl) == b.level_max_ray_cells(lvl)
    assert a.map.top_left_offset == b.map.top_left_offset
    assert a.update.log_odds_free == b.update.log_odds_free
    assert a.update.log_odds_occupied == b.update.log_odds_occupied


@pytest.mark.parametrize("name", ["BENCH_CONFIG", "DEFAULT_CONFIG",
                                  "CITYFLYER_LOG_CONFIG"])
def test_transforms_bit_equal(name):
    cfg = getattr(jcfg, name)
    rng = np.random.default_rng(11)
    xy = rng.uniform(-60.0, 60.0, (512, 2)).astype(np.float32)
    pose = np.c_[xy, rng.uniform(-3, 3, 512)].astype(np.float32)
    off = cfg.map.top_left_offset
    for lvl in range(cfg.map.levels):
        s, cl = cfg.map.level_scale(lvl), cfg.map.level_resolution(lvl)
        eq(tgrid.world_to_map(T(xy), off, s), jgrid.world_to_map(xy, off, s))
        eq(tgrid.map_to_world(T(xy), off, cl),
           jgrid.map_to_world(jnp.asarray(xy), off, cl))
        eq(tgrid.world_to_map_pose(T(pose), off, s),
           jgrid.world_to_map_pose(jnp.asarray(pose), off, s))
        eq(tgrid.map_to_world_pose(T(pose), off, cl),
           jgrid.map_to_world_pose(jnp.asarray(pose), off, cl))


def test_normalize_angle_bit_equal():
    rng = np.random.default_rng(12)
    pi32 = np.float32(np.pi)
    edges = np.array([0.0, pi32, -pi32, np.nextafter(pi32, np.float32(4)),
                      np.nextafter(-pi32, np.float32(-4)), 2 * pi32,
                      -2 * pi32, 7.5, -9.25, 1e-8, -1e-8], np.float32)
    a = np.concatenate([rng.uniform(-6.3, 6.3, 4096).astype(np.float32),
                        edges])
    eq(tgrid.normalize_angle(T(a)), jgrid.normalize_angle(jnp.asarray(a)))


def test_pose_difference_bit_equal():
    rng = np.random.default_rng(13)
    for _ in range(200):
        p1 = rng.normal(0, 0.5, 3).astype(np.float32)
        p2 = (p1 + rng.normal(0, 0.3, 3)).astype(np.float32)
        p2[2] = rng.uniform(-3.5, 3.5)
        for d, a in ((0.4, 0.9), (0.3, 0.03), (0.0, 0.0)):
            got = bool(tgrid.pose_difference_larger_than(T(p1), T(p2), d, a))
            want = bool(jgrid.pose_difference_larger_than(
                jnp.asarray(p1), jnp.asarray(p2), d, a))
            assert got == want


def test_solve3_and_det3_bit_equal():
    rng = np.random.default_rng(14)
    a = rng.normal(0, 1, (256, 3, 3)).astype(np.float32)
    h = (a @ a.transpose(0, 2, 1) + np.eye(3, dtype=np.float32) * 0.1)
    h = h.astype(np.float32)
    b = rng.normal(0, 1, (256, 3)).astype(np.float32)
    eq(tsolve.det3(T(h)), jsolve.det3(jnp.asarray(h)))
    eq(tsolve.solve3(T(h), T(b)), jsolve.solve3(jnp.asarray(h),
                                                 jnp.asarray(b)))


def _ulp_gap(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("model", ["log_odds", "simple_count",
                                   "reflectance"])
def test_prob_grid_ulp_gap(model):
    """torch.exp and XLA's CPU exp round differently: measured on 64k
    log-odds values over [-60, 50], exp differs by at most 1 ulp (on ~10%
    of cells) and odds/(odds+1) by at most 2 ulp (~5% of cells). The
    probability models have no transcendental and are bit-equal."""
    rng = np.random.default_rng(15)
    if model == "reflectance":
        visited = rng.integers(0, 20, (2, 128, 256)).astype(np.float32)
        storage = np.stack([visited[0], np.minimum(visited[0],
                                                   visited[1])])
    elif model == "log_odds":
        storage = rng.uniform(-60.0, 50.0, (256, 256)).astype(np.float32)
    else:
        storage = rng.uniform(0.0, 1.0, (256, 256)).astype(np.float32)
    got = tcm.prob_grid(T(storage), model).numpy()
    want = np.asarray(jcm.prob_grid(jnp.asarray(storage), model))
    assert _ulp_gap(got, want) <= (2 if model == "log_odds" else 0)
    if model == "log_odds":
        assert _ulp_gap(torch.exp(T(storage)).numpy(),
                        np.asarray(jnp.exp(storage))) <= 1


@pytest.mark.parametrize("model", ["log_odds", "simple_count",
                                   "reflectance"])
def test_apply_update_bit_equal(model):
    rng = np.random.default_rng(16)
    shape = (2, 64, 96) if model == "reflectance" else (64, 96)
    if model == "log_odds":
        storage = rng.uniform(-5.0, 55.0, shape).astype(np.float32)
    else:
        storage = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    occ = rng.random((64, 96)) < 0.2
    free = (rng.random((64, 96)) < 0.4) & ~occ
    lf, lo = jcfg.BENCH_CONFIG.update.log_odds_free, \
        jcfg.BENCH_CONFIG.update.log_odds_occupied
    eq(tcm.apply_update(T(storage), T(free), T(occ), model, lf, lo),
       jcm.apply_update(jnp.asarray(storage), jnp.asarray(free),
                        jnp.asarray(occ), model, lf, lo))


def test_quad_pack_and_interp_bit_equal():
    rng = np.random.default_rng(17)
    prob = rng.random((48, 40)).astype(np.float32)
    tq = tinterp.quad_pack(T(prob))
    eq(tq, jinterp.quad_pack(jnp.asarray(prob)))
    coords = np.stack([rng.uniform(-2, 42, 600), rng.uniform(-2, 50, 600)],
                      -1).astype(np.float32)
    coords[:4] = [[38.0, 10.0], [38.0001, 10.0], [-0.0001, 3.0],
                  [0.0, 46.0]]       # the size-2 bounds rule, both sides
    got = np.stack([t.numpy() for t in tinterp.interp_quad(
        tq, (48, 40), T(coords))])
    want = np.stack([np.asarray(a) for a in jinterp.interp_quad(
        jinterp.quad_pack(jnp.asarray(prob)), (48, 40),
        jnp.asarray(coords))])
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] != 0.0 and (got[:, 1] == 0.0).all() \
        and (got[:, 2] == 0.0).all() and got[0, 3] != 0.0
    # the quad path is bit-equal to the 4-gather spec of the port itself
    lo = rng.normal(0, 1.5, (48, 40)).astype(np.float32)
    spec = np.stack([t.numpy() for t in tinterp.interp_with_derivatives(
        T(lo), T(coords))])
    quad = np.stack([t.numpy() for t in tinterp.interp_quad(
        tinterp.quad_pack_storage(T(lo), "log_odds"), (48, 40),
        T(coords))])
    np.testing.assert_array_equal(quad, spec)


def test_quirk_gradient_golden():
    """Only P10 = (y=0, x=1) occupied, query (0.25, 0.75): the x-gradient
    blends row differences with the x fraction, the y-gradient column
    differences with the y fraction (OccGridMapUtil.h:332-346)."""
    lo = np.zeros((4, 4), np.float32)
    lo[0, 1] = 2.0
    p10 = np.float32(np.exp(2.0) / (np.exp(2.0) + 1.0))
    fx, fy = np.float32(0.25), np.float32(0.75)
    v, gx, gy = tinterp.interp_with_derivatives(
        T(lo), T(np.array([[0.25, 0.75]], np.float32)))
    np.testing.assert_allclose(float(v[0]), (0.5 * (1 - fx) + p10 * fx)
                               * (1 - fy) + 0.5 * fy, rtol=1e-6)
    np.testing.assert_allclose(float(gx[0]), -((0.5 - p10) * (1 - fx)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(gy[0]), -((p10 - 0.5) * fy), rtol=1e-6)


def _random_scan(rng, n=256, n_valid=200, reach=90.0):
    ang = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(0.5, reach, n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    mask = np.arange(n) < n_valid
    origo = rng.normal(0, 0.3, 2).astype(np.float32)
    return pts, origo, mask


@pytest.mark.parametrize("case", ["inside", "edge", "empty"])
def test_rasterize_cell_sets_bit_equal(case):
    """Free and occupied cell sets equal JAX's for equal f32 poses,
    including endpoints beyond the map edge and an empty scan."""
    rng = np.random.default_rng({"inside": 21, "edge": 22, "empty": 23}[case])
    h, w = 128, 160
    offset, scale = (4.0, 3.2), 20.0     # 0.05 m cells
    for _ in range(6):
        pts, origo, mask = _random_scan(
            rng, reach=40.0 if case == "inside" else 200.0)
        if case == "empty":
            mask[:] = False
        pose = np.array([rng.normal(0, 0.5), rng.normal(0, 0.5),
                         rng.uniform(-3, 3)], np.float32)
        t = tmap.rasterize_scan((h, w), T(pose), T(pts), T(origo), T(mask),
                                offset, scale, 176)
        j = jmap.rasterize_scan((h, w), jnp.asarray(pose), jnp.asarray(pts),
                                jnp.asarray(origo), jnp.asarray(mask),
                                offset, scale, 176)
        for a, b in zip(t, j):
            eq(a, b)
        if case == "empty":
            assert not t[0].any() and not t[1].any()
        else:
            assert t[0].any() and t[1].any()


def test_truncated_count_equal():
    rng = np.random.default_rng(24)
    pts, origo, mask = _random_scan(rng, reach=60.0)
    pose = np.zeros(3, np.float32)
    t = tmap.rasterize_scan((128, 160), T(pose), T(pts), T(origo), T(mask),
                            (4.0, 3.2), 20.0, 16)
    j = jmap.rasterize_scan((128, 160), jnp.asarray(pose), jnp.asarray(pts),
                            jnp.asarray(origo), jnp.asarray(mask),
                            (4.0, 3.2), 20.0, 16)
    assert int(t[2]) == int(j[2]) > 0
    eq(t[0], j[0])


@pytest.mark.parametrize("model", ["log_odds", "reflectance"])
def test_update_pyramid_bit_equal(model):
    jc = jcfg.SlamConfig(
        map=jcfg.MapConfig(resolution=0.05, size_x=160, size_y=128,
                           levels=3),
        update=jcfg.UpdateConfig(cell_model=model), max_ray_cells=200)
    tc = tcfg.SlamConfig(
        map=tcfg.MapConfig(resolution=0.05, size_x=160, size_y=128,
                           levels=3),
        update=tcfg.UpdateConfig(cell_model=model), max_ray_cells=200)
    rng = np.random.default_rng(25)
    jp = jgrid.init_log_odds_pyramid(jc.map, model)
    tp = tgrid.init_log_odds_pyramid(tc.map, model, device="cpu")
    for _ in range(4):
        pts, origo, mask = _random_scan(rng, reach=70.0)
        pose = np.array([rng.normal(0, 0.3), rng.normal(0, 0.3),
                         rng.uniform(-3, 3)], np.float32)
        jp, jt = jmap.update_pyramid(
            jp, jnp.asarray(pose),
            JScan(jnp.asarray(pts), jnp.asarray(origo), jnp.asarray(mask)),
            jc, raster_backend="xla")
        tp, tt = tmap.update_pyramid(tp, T(pose),
                                     TScan(T(pts), T(origo), T(mask)), tc)
        assert int(tt) == int(jt)
    for a, b in zip(tp, jp):
        eq(a, b)
        assert (a != a.flatten()[0]).any()


@pytest.mark.parametrize("model", ["log_odds", "reflectance"])
@pytest.mark.parametrize("robots", [0, 3])
def test_update_level_bit_equal(model, robots):
    """update_level, one scan into one map (robots=0) or R scans each into
    its own map, equals JAX's update_level run robot by robot: storage
    and truncated counts, over two chained updates."""
    offset, scale, cap = (4.0, 3.2), 20.0, 120
    lf, lo_occ = -0.4, 0.9
    rng = np.random.default_rng(26 + robots)
    base = np.asarray(jgrid.init_log_odds_pyramid(
        jcfg.MapConfig(resolution=0.05, size_x=160, size_y=128, levels=1),
        model)[0])
    jmaps = [jnp.asarray(base)] * max(robots, 1)
    tmaps = T(base) if robots == 0 else T(np.stack([base] * robots))
    for _ in range(2):
        scans = [_random_scan(rng, reach=70.0) for _ in range(max(robots, 1))]
        poses = [np.array([rng.normal(0, 0.3), rng.normal(0, 0.3),
                           rng.uniform(-3, 3)], np.float32) for _ in scans]
        pts, origo, mask = (np.stack(x) for x in zip(*scans))
        pose = np.stack(poses)
        if robots == 0:
            pts, origo, mask, pose = pts[0], origo[0], mask[0], pose[0]
        tmaps, tt = tmap.update_level(tmaps, T(pose), T(pts), T(origo),
                                      T(mask), offset, scale, cap, lf,
                                      lo_occ, cell_model=model)
        for i, ((p, o, m), ps) in enumerate(zip(scans, poses)):
            jmaps[i], jt = jmap.update_level(
                jmaps[i], jnp.asarray(ps), jnp.asarray(p), jnp.asarray(o),
                jnp.asarray(m), offset, scale, cap, lf, lo_occ,
                cell_model=model, raster_backend="xla")
            assert int(tt.reshape(-1)[i]) == int(jt)
    eq(tmaps, jmaps[0] if robots == 0 else jnp.stack(jmaps))
    assert (tmaps != tmaps.flatten()[0]).any()
