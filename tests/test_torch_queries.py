"""The port's query and auxiliary modules against the JAX package on the
CPU, on the same seeded inputs: ``hessian_derivs`` and ``log_odds_to_prob``
(mirrors tests/test_interp.py:60-100), the sigma-point covariance and
match likelihood (tests/test_session.py:198-216), the GN debug diagnostics
(tests/test_ecosystem.py:223-240), the raycast queries (:168-204,
:322-336), the markers (:357-378) and the attitude utilities (:279-291,
:409-443).

Tolerances: H within 1e-5 of max|H| (the matcher's bar,
tests/test_torch_matcher.py: torch sums the moments in ``beam_sum``'s
order, XLA as a dot); the covariance within 1e-5 of max|cov| and the
likelihood within 1e-6 (sums over beams in other orders); the debug pose
bit-equal to the port's own ``match_pyramid`` and within 1e-4 of JAX's,
its Hessians within 1e-5 of each iteration's max|H|, determinants within
1e-4 relative (a sum of products of three entries, each held to 1e-5: at
full width, BENCH_CONFIG after the 435-scan replay, the finest level's
read 2.05e-5 apart), condition numbers within 1e-3 relative (eigvalsh of
the two libraries); raycasts, normals,
search positions, markers and attitude equal (integers exactly, floats
within 1e-6)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hector_slam_tpu.config as jc
from hector_slam_tpu.core import covariance as jcov
from hector_slam_tpu.core.debug import match_pyramid_debug_jit
from hector_slam_tpu.core.grid import log_odds_to_prob as j_prob
from hector_slam_tpu.core.grid import world_to_map_pose as j_w2m
from hector_slam_tpu.core.interp import hessian_derivs as j_hessian
from hector_slam_tpu.core.matcher import match_pyramid as j_match
from hector_slam_tpu.core.slam import init_state, slam_step_jit
from hector_slam_tpu.export import markers as jmk
from hector_slam_tpu.export.occupancy import GridMeta as JMeta
from hector_slam_tpu.export.occupancy import grid_meta as j_grid_meta
from hector_slam_tpu.io import attitude as jatt
from hector_slam_tpu.io.scanlog import LaserModel as JLaser
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.oracle.oracle_np import OracleMap
from hector_slam_tpu.query import raycast as jray

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import covariance as tcov
from hector_slam_tpu_torch.core.debug import match_pyramid_debug
from hector_slam_tpu_torch.core.grid import log_odds_to_prob
from hector_slam_tpu_torch.core.grid import world_to_map_pose
from hector_slam_tpu_torch.core.interp import (hessian_derivs,
                                               hessian_derivs_quad,
                                               quad_pack_storage)
from hector_slam_tpu_torch.export import markers as tmk
from hector_slam_tpu_torch.io import attitude as tatt
from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                simulate_trajectory)
from hector_slam_tpu_torch.query import raycast as tray

MAP_KW = dict(resolution=0.05, size_x=256, size_y=256, levels=2)
JCFG = jc.SlamConfig(map=jc.MapConfig(**MAP_KW), max_beams=384,
                     max_ray_cells=256)
TCFG = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_beams=384,
                     max_ray_cells=256)
LASER_KW = dict(num_beams=271, angle_min=-2.356194490192345,
                angle_increment=4 * 0.004363323129985824, range_min=0.1,
                range_max=12.0)
TL, JL = ht.LaserModel(**LASER_KW), JLaser(**LASER_KW)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def T(a):
    return torch.from_numpy(np.array(a))


def _scan_pair(ranges):
    scale = TCFG.map.level_scale(0)
    return (j_scan(ranges, scale, JL, JCFG.max_beams),
            ht.scan_from_ranges(ranges, scale, TL, TCFG.max_beams,
                                device="cpu"))


def _mapped(world, n):
    """A JAX map built from n corridor scans at their known poses, the same
    levels as port tensors, the poses and the ranges."""
    poses = corridor_trajectory(n, advance=0.06, weave=0.03)
    ranges = simulate_trajectory(world, poses, TL)
    state = init_state(JCFG)
    for r, p in zip(ranges, poses):
        state, _ = slam_step_jit(state, _scan_pair(r)[0], JCFG,
                                 pose_hint=jnp.asarray(p),
                                 map_without_matching=True)
    return state, [T(lo) for lo in state.log_odds], poses, ranges


@pytest.fixture(scope="module")
def corridor():
    """tests/test_session.py's log: the 8 m corridor, 12 poses."""
    return _mapped(World.corridor(length=8.0, width=3.0), 12)


@pytest.fixture(scope="module")
def room():
    """tests/test_ecosystem.py's mapped state: the 10 m room, 10 poses."""
    return _mapped(World.room(size=10.0), 10)


# ---- interp: hessian_derivs, log_odds_to_prob (tests/test_interp.py) ----


def _oracle_map(seed):
    m = OracleMap(32, 32, 0.1, (1.6, 1.6))
    rng = np.random.default_rng(seed)
    m.log_odds[:] = rng.normal(0.0, 2.0, m.log_odds.shape).astype(np.float32)
    return m


def test_hessian_derivs_matches_oracle_and_jax():
    m = _oracle_map(3)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-8.0, 8.0, (200, 2)).astype(np.float32)
    pose = np.array([16.0, 15.0, 0.3], np.float32)
    mask = np.ones(len(pts), bool)
    h, d = hessian_derivs(T(m.log_odds), T(pose), T(pts), T(mask))
    h_o, d_o = m.complete_hessian_derivs(pose, pts)
    # the oracle sums serially in f32 (tests/test_interp.py:76-84)
    np.testing.assert_allclose(h.numpy(), h_o, rtol=1e-3, atol=2e-2)
    np.testing.assert_allclose(d.numpy(), d_o, rtol=1e-3, atol=2e-2)
    h_j, d_j = j_hessian(jnp.asarray(m.log_odds), jnp.asarray(pose),
                         jnp.asarray(pts), jnp.asarray(mask))
    scale = float(np.abs(np.asarray(h_j)).max())
    assert np.abs(h.numpy() - np.asarray(h_j)).max() <= 1e-5 * scale
    assert np.abs(d.numpy() - np.asarray(d_j)).max() <= 1e-5 * float(
        np.abs(np.asarray(d_j)).max())


def test_hessian_derivs_mask_equals_dropping_points():
    m = _oracle_map(5)
    rng = np.random.default_rng(6)
    pts = rng.uniform(-8.0, 8.0, (64, 2)).astype(np.float32)
    mask = np.zeros(64, bool)
    mask[:40] = True
    pose = T(np.array([14.0, 17.0, -0.7], np.float32))
    lo = T(m.log_odds)
    h_a, d_a = hessian_derivs(lo, pose, T(pts), T(mask))
    h_b, d_b = hessian_derivs(lo, pose, T(pts[:40]), torch.ones(40,
                                                               dtype=bool))
    np.testing.assert_allclose(h_a.numpy(), h_b.numpy(), atol=1e-5)
    np.testing.assert_allclose(d_a.numpy(), d_b.numpy(), atol=1e-5)


def test_hessian_derivs_is_the_matchers_sum():
    """Built on the quad path: bit-equal to hessian_derivs_quad over the
    packed storage, for every cell model the matcher reads."""
    rng = np.random.default_rng(7)
    pose = T(np.array([20.0, 18.0, 0.3], np.float32))
    pts = T(rng.uniform(-15, 15, (64, 2)).astype(np.float32))
    mask = T(rng.uniform(size=64) > 0.2)
    for model, lo in (("log_odds", rng.normal(0, 1.5, (48, 40))),
                      ("simple_count", rng.uniform(0, 1, (48, 40)))):
        lo = T(lo.astype(np.float32))
        got = hessian_derivs(lo, pose, pts, mask, model)
        want = hessian_derivs_quad(quad_pack_storage(lo, model), (48, 40),
                                   pose, pts, mask)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_log_odds_to_prob_matches_jax():
    lo = np.random.default_rng(8).normal(0, 4, 4096).astype(np.float32)
    lo[:3] = (50.0, -50.0, 0.0)
    got = log_odds_to_prob(T(lo)).numpy()
    want = np.asarray(j_prob(jnp.asarray(lo)))
    # exp differs by at most an ulp between torch and XLA
    # (tests/test_torch_core.py::test_prob_grid_ulp_gap)
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    assert got[2] == 0.5


# ---- covariance (tests/test_session.py:198-216) ----


def test_sigma_point_covariance_and_likelihood_match_jax(corridor):
    state, levels, poses, ranges = corridor
    for i in (3, 5, 9):
        js, ts = _scan_pair(ranges[i])
        pm_j = j_w2m(jnp.asarray(poses[i]), JCFG.map.top_left_offset,
                     JCFG.map.level_scale(0))
        pm = world_to_map_pose(T(poses[i]), TCFG.map.top_left_offset,
                               TCFG.map.level_scale(0))
        assert torch.equal(pm, T(np.asarray(pm_j)))
        cov = tcov.sigma_point_covariance(levels[0], pm, ts).numpy()
        want = np.asarray(jcov.sigma_point_covariance_jit(
            state.log_odds[0], pm_j, js))
        assert cov.shape == (3, 3)
        assert np.abs(cov - want).max() <= 1e-5 * np.abs(want).max()
        np.testing.assert_array_equal(cov, cov.T)
        assert np.all(np.diag(cov) >= 0)
        lh = float(tcov.likelihood_for_state(levels[0], pm, ts))
        assert 0.0 < lh <= 1.0
        assert abs(lh - float(jcov.likelihood_for_state(
            state.log_odds[0], pm_j, js))) <= 1e-6
        res = float(tcov.residual_for_state(levels[0], pm, ts))
        want_res = float(jcov.residual_for_state(state.log_odds[0], pm_j, js))
        assert abs(res - want_res) <= 1e-6 * max(abs(want_res), 1.0)
    coords = np.random.default_rng(9).uniform(-2, 258, (500, 2)).astype(
        np.float32)
    v = tcov.interp_map_value(levels[0], T(coords)).numpy()
    vj = np.asarray(jcov.interp_map_value(state.log_odds[0],
                                          jnp.asarray(coords)))
    np.testing.assert_allclose(v, vj, rtol=0, atol=1e-6)
    assert ((0.0 <= v) & (v <= 1.0)).all()
    v = float(tcov.interp_map_value(levels[0], T([[128.0, 128.0]]))[0])
    assert 0.0 <= v <= 1.0


def test_likelihood_of_an_empty_scan_is_one(corridor):
    """The max(n, 1) guard: no valid beam reads a likelihood of 1."""
    state, levels, poses, _ = corridor
    empty = ht.Scan(torch.zeros(8, 2), torch.zeros(2),
                    torch.zeros(8, dtype=torch.bool))
    pm = world_to_map_pose(T(poses[0]), TCFG.map.top_left_offset,
                           TCFG.map.level_scale(0))
    assert float(tcov.likelihood_for_state(levels[0], pm, empty)) == 1.0


# ---- debug diagnostics (tests/test_ecosystem.py:223-240) ----


def test_match_pyramid_debug_matches_matcher_and_jax(room):
    state, levels, poses, _ = room
    r = simulate_trajectory(World.room(size=10.0), poses[-1:], TL)[0]
    js, ts = _scan_pair(r)
    start = poses[-1] + np.asarray([0.04, -0.03, 0.02], np.float32)
    pose, hess, diag = match_pyramid_debug(levels, T(start), ts, TCFG)
    n_iter = ((TCFG.match.iterations_coarse + 1)
              + (TCFG.match.iterations_finest + 1))
    assert diag.hessian.shape == (n_iter, 3, 3)
    for f in diag[1:]:
        assert f.shape == (n_iter,)
    assert torch.equal(diag.hessian[-1], hess)
    d = diag.determinant.numpy()
    assert np.isfinite(d).all() and d[-1] > 0
    assert float(diag.condition_num[-1]) >= 1.0
    assert float(diag.condition_num_2d[-1]) >= 1.0
    # the port's own matcher, bit for bit
    want = ht.match_pyramid(levels, T(start), ts, TCFG)
    assert torch.equal(pose, want.pose) and torch.equal(hess, want.hessian)
    # JAX's debug matcher
    jpose, jhess, jdiag = match_pyramid_debug_jit(
        state.log_odds, jnp.asarray(start), js, JCFG)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-4)
    np.testing.assert_allclose(
        pose.numpy(), np.asarray(j_match(state.log_odds, jnp.asarray(start),
                                         js, JCFG).pose), atol=1e-4)

    def rel(a, b, axis=None):
        b = np.asarray(b)
        return float((np.abs(a.numpy() - b).max(axis=axis)
                      / np.abs(b).max(axis=axis)).max())

    assert rel(diag.hessian.reshape(n_iter, 9),
               np.asarray(jdiag.hessian).reshape(n_iter, 9), axis=1) <= 1e-5
    _assert_diag_close(diag, {k: np.asarray(v)
                              for k, v in jdiag._asdict().items()})


def _assert_diag_close(diag, want):
    """Each iteration's Hessian within 1e-5 of its max|H|, determinants
    within 1e-4 relative, condition numbers within 1e-3 relative (module
    docstring)."""
    n = len(want["hessian"])
    h, hj = diag.hessian.numpy().reshape(n, 9), want["hessian"].reshape(n, 9)
    assert (np.abs(h - hj).max(1) / np.abs(hj).max(1)).max() <= 1e-5
    for name, tol in (("determinant", 1e-4), ("determinant_2d", 1e-4),
                      ("condition_num", 1e-3), ("condition_num_2d", 1e-3)):
        err = np.abs(getattr(diag, name).numpy() - want[name]) \
            / np.abs(want[name])
        assert err.max() <= tol, (name, err)


# ---- raycast (tests/test_ecosystem.py:168-204, :322-336) ----


def _wall_grid():
    occ = np.zeros((64, 64), np.int8)
    occ[:, 40] = 100
    return occ


def test_raycast_distance_matches_jax():
    occ = _wall_grid()
    tmeta = ht.GridMeta(resolution=0.1, origin=(0.0, 0.0), width=64,
                        height=64)
    jmeta = JMeta(resolution=0.1, origin=(0.0, 0.0), width=64, height=64)
    dist, hit = tray.distance_to_obstacle(occ, tmeta, (1.0, 3.2), (6.0, 3.2))
    assert abs(dist - 3.0) < 1e-6 and abs(hit[0] - 4.0) < 1e-6
    d2, h2 = tray.distance_to_obstacle(occ, tmeta, (1.0, 3.2), (3.0, 3.2))
    assert d2 == -1.0 and h2 is None
    assert tray.distance_to_obstacle(occ, tmeta, (-1.0, 3.2),
                                     (6.0, 3.2))[0] == -1.0
    d4 = tray.get_distance_to_obstacle(occ, tmeta, (1.0, 3.2), (2.0, 3.2))
    assert abs(d4 - 3.0) < 1e-6
    d5 = tray.get_distance_to_obstacle(occ, tmeta, (1.0, 3.2, 0.0),
                                       (2.0, 3.2, 1.0))
    assert d5 > d4
    # a random map and rays, against JAX: scalar and service forms, the
    # grid given as numpy and as a tensor
    rng = np.random.default_rng(10)
    g = np.where(rng.uniform(size=(64, 64)) < 0.04, 100,
                 rng.choice([-1, 0], (64, 64))).astype(np.int8)
    for _ in range(64):
        b, e = rng.uniform(-0.5, 6.9, (2, 2))
        got = tray.distance_to_obstacle(torch.from_numpy(g), tmeta, b, e)
        want = jray.distance_to_obstacle(g, jmeta, b, e)
        assert got[0] == want[0]
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            np.testing.assert_array_equal(got[1], want[1])
        p3 = np.r_[e, rng.uniform(-1, 1)]
        assert tray.get_distance_to_obstacle(g, tmeta, b, p3) == \
            jray.get_distance_to_obstacle(g, jmeta, b, p3)


def test_raycast_batch_matches_jax_and_the_scalar_walk():
    occ = _wall_grid()
    begins = np.asarray([[10, 32], [10, 32], [-1, 0]], np.int32)
    ends = np.asarray([[60, 32], [30, 32], [5, 5]], np.int32)
    bd = tray.distance_to_obstacle_batch(torch.from_numpy(occ), begins,
                                         ends, max_cells=128).numpy()
    assert bd[0] == 30.0 and bd[1] == -1.0 and bd[2] == -1.0
    rng = np.random.default_rng(11)
    g = np.where(rng.uniform(size=(96, 80)) < 0.03, 100, 0).astype(np.int8)
    begins = rng.integers(-4, 100, (2048, 2)).astype(np.int32)
    ends = rng.integers(-4, 100, (2048, 2)).astype(np.int32)
    got = tray.distance_to_obstacle_batch(g, begins, ends, max_cells=128,
                                          device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(jray.distance_to_obstacle_batch(
        jnp.asarray(g), jnp.asarray(begins), jnp.asarray(ends),
        max_cells=128))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).sum() > 200 and (got < 0).sum() > 200
    # the scalar walk reads the same cell distance at each cell centre
    # (cells at -1 are left out: the walk truncates -0.5 to cell 0)
    meta = ht.GridMeta(resolution=1.0, origin=(0.0, 0.0), width=80,
                       height=96)
    for i in np.flatnonzero((begins >= 0).all(1) & (ends >= 0).all(1))[::5]:
        d, _ = tray.distance_to_obstacle(g, meta, begins[i] + 0.5,
                                         ends[i] + 0.5)
        assert d == float(got[i])


def test_search_position_and_normal_match_jax():
    pose = np.asarray([2.0, 1.0, np.pi / 2], np.float32)
    out = tray.get_search_position(torch.from_numpy(pose), 0.5)
    np.testing.assert_allclose(out[:2], [2.0, 0.5], atol=1e-6)
    assert out[2] == pose[2]
    np.testing.assert_array_equal(out, jray.get_search_position(pose, 0.5))

    mcfg = dict(resolution=0.1, size_x=100, size_y=100)
    tmeta = ht.grid_meta(ht.MapConfig(**mcfg))
    jmeta = j_grid_meta(jc.MapConfig(**mcfg))
    g = np.zeros((100, 100), np.int8)
    g[:, 60] = 100
    robot = np.asarray([-1.0, 0.0])
    n = tray.get_normal(g, tmeta, robot, np.asarray([4.0, 0.0]))
    np.testing.assert_allclose(n, [-1.0, 0.0], atol=1e-6)
    assert tray.get_normal(np.zeros((100, 100), np.int8), tmeta, robot,
                           np.asarray([4.0, 0.0])) is None
    rng = np.random.default_rng(12)
    g = np.where(rng.uniform(size=(100, 100)) < 0.05, 100, 0).astype(np.int8)
    g[30:33, :] = 100
    for _ in range(32):
        robot, target = rng.uniform(-4.5, 4.5, (2, 2))
        got = tray.get_normal(torch.from_numpy(g), tmeta, robot, target)
        want = jray.get_normal(g, jmeta, robot, target)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---- markers (tests/test_ecosystem.py:357-378) ----


def test_markers_match_jax():
    half, ang, poly = tmk.covariance_ellipse(np.diag([4.0, 1.0]))
    np.testing.assert_allclose(half, [2.0, 1.0], atol=1e-6)
    assert abs(ang) < 1e-9 and poly.shape == (32, 2)
    c, s = np.cos(0.785398), np.sin(0.785398)
    rot = np.asarray([[c, -s], [s, c]])
    cov = rot @ np.diag([4.0, 1.0]) @ rot.T
    half, ang, _ = tmk.covariance_ellipse(torch.from_numpy(cov))
    np.testing.assert_allclose(half, [2.0, 1.0], atol=1e-6)
    assert abs(ang - 0.785398) < 1e-6
    segs = tmk.arrow_marker([1.0, 2.0, 0.0], length=0.5)
    assert segs.shape == (3, 4)
    np.testing.assert_allclose(segs[0], [1.0, 2.0, 1.5, 2.0], atol=1e-6)
    assert tmk.pose_markers(torch.zeros(4, 3)).shape == (12, 4)
    rng = np.random.default_rng(13)
    for _ in range(16):
        a = rng.normal(size=(2, 2))
        cov = a @ a.T
        got, want = (tmk.covariance_ellipse(torch.from_numpy(cov), 2.0, 12),
                     jmk.covariance_ellipse(cov, 2.0, 12))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
    poses = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmk.pose_markers(torch.from_numpy(poses),
                                                   0.7),
                                  jmk.pose_markers(poses, 0.7))


# ---- attitude (tests/test_ecosystem.py:279-291, :409-443) ----


def test_attitude_fusion_matches_jax():
    q = tatt.rpy_to_quaternion(0.1, -0.2, 1.5)
    assert q == jatt.rpy_to_quaternion(0.1, -0.2, 1.5)
    np.testing.assert_allclose(tatt.quaternion_to_rpy(q), [0.1, -0.2, 1.5],
                               atol=1e-9)
    qs = tatt.attitude_to_stabilized_transform(torch.tensor(q,
                                                            dtype=float))
    assert qs == jatt.attitude_to_stabilized_transform(q)
    np.testing.assert_allclose(tatt.quaternion_to_rpy(qs), [0.1, -0.2, 0.0],
                               atol=1e-9)
    qf = tatt.fuse_pose_and_attitude(torch.tensor([0.0, 0.0, 0.77]), q)
    np.testing.assert_allclose(tatt.quaternion_to_rpy(qf), [0.1, -0.2, 0.77],
                               atol=1e-6)
    rng = np.random.default_rng(14)
    for _ in range(32):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        assert tatt.quaternion_to_rpy(q) == jatt.quaternion_to_rpy(q)
        pose = rng.normal(size=3).astype(np.float32)
        assert tatt.fuse_pose_and_attitude(pose, q) == \
            jatt.fuse_pose_and_attitude(pose, q)


def test_imu_pose_fuser_matches_jax():
    """hector_imu_tools' node (pose_and_orientation_to_imu_node.cpp:
    65-159): the tf chain per pose, fused attitude per IMU message,
    odometry every 5th IMU message; step for step as the JAX fuser."""
    imu = tatt.rpy_to_quaternion(0.1, -0.2, 2.0)
    ports, jaxs = (tatt.ImuPoseFuser(), tatt.ImuPoseFuser(3)), \
        (jatt.ImuPoseFuser(), jatt.ImuPoseFuser(3))
    for f, g in zip(ports, jaxs):
        fused, odom = f.on_imu(imu)
        assert (fused, odom) == g.on_imu(imu) and odom is None
        r, p, y = tatt.quaternion_to_rpy(fused["orientation"])
        assert abs(r - 0.1) < 1e-6 and abs(p + 0.2) < 1e-6 and abs(y) < 1e-6
        got = f.on_pose(torch.tensor([1.0, 2.0]), yaw=0.7, stamp=1.0)
        assert got == g.on_pose((1.0, 2.0), yaw=0.7, stamp=1.0)
        assert got[0]["translation"] == (1.0, 2.0, 0.0)
        assert got[1]["rotation"] == (0.0, 0.0, 0.0, 1.0)
        odoms = []
        for i in range(1, 11):
            out = f.on_imu(imu, stamp=float(i))
            assert out == g.on_imu(imu, stamp=float(i))
            assert abs(tatt.quaternion_to_rpy(out[0]["orientation"])[2]
                       - 0.7) < 1e-6
            odoms.append(out[1] is not None)
        period = f.odom_decimation
        assert odoms == [i % period == 0 for i in range(1, 11)]


# ---- the card's reference (tests/fixtures/queries_jax_reference.npz) ----


def test_queries_reference_fixture_on_the_cpu():
    """The JAX answers chip_smoke.py holds the card to, reproduced by the
    port on the CPU from the fixture's JAX checkpoint (BENCH_CONFIG, the
    435-scan corridor replay): covariance, likelihood, debug match, a
    slice of the 65,536 rays and the 64 scalar rays. Rewrite the fixture
    with tools/make_torch_queries_reference.py."""
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "queries_jax_reference.npz")
    cfg = ht.BENCH_CONFIG
    state = ht.load_state(path, cfg, device="cpu")
    ref = np.load(path)
    np.testing.assert_array_equal(state.pose.numpy(), ref["poses"][-1])
    scan = ht.scan_from_numpy(ref["scan_points"], ref["scan_origo"],
                              ref["scan_mask"], device="cpu")
    pm = world_to_map_pose(state.pose, cfg.map.top_left_offset,
                           cfg.map.level_scale(0))
    np.testing.assert_array_equal(pm.numpy(), ref["pose_map"])
    cov = tcov.sigma_point_covariance(state.log_odds[0], pm, scan).numpy()
    assert np.abs(cov - ref["covariance"]).max() <= \
        1e-5 * np.abs(ref["covariance"]).max()
    assert abs(float(tcov.likelihood_for_state(state.log_odds[0], pm, scan))
               - float(ref["likelihood"])) <= 1e-6
    pose, hess, diag = match_pyramid_debug(
        state.log_odds, T(ref["debug_start"]), scan, cfg)
    np.testing.assert_allclose(pose.numpy(), ref["debug_pose"], atol=1e-4)
    assert diag.hessian.shape == ref["diag_hessian"].shape == (14, 3, 3)
    _assert_diag_close(diag, {k: ref[f"diag_{k}"] for k in diag._fields})
    assert torch.equal(pose, ht.match_pyramid(state.log_odds,
                                              T(ref["debug_start"]), scan,
                                              cfg, quads=state.quads).pose)
    occ = ht.to_occupancy_grid(state.log_odds[0])
    rays = slice(0, 65536, 16)
    got = ht.distance_to_obstacle_batch(
        torch.from_numpy(occ), ref["ray_begins"][rays], ref["ray_ends"][rays],
        max_cells=1024)
    np.testing.assert_array_equal(got.numpy(), ref["ray_distances"][rays])
    meta = ht.grid_meta(cfg.map)
    robot = ref["scalar_robot"]
    for p, d, hit, sd, n in zip(ref["scalar_points"], ref["scalar_distances"],
                                ref["scalar_hits"], ref["service_distances"],
                                ref["normals"]):
        gd, gh = ht.distance_to_obstacle(occ, meta, robot, p[:2])
        assert gd == d
        np.testing.assert_array_equal(np.full(2, np.nan) if gh is None
                                      else gh, hit)
        assert ht.get_distance_to_obstacle(occ, meta, robot, p) == sd
        gn = ht.get_normal(occ, meta, robot, p)
        np.testing.assert_allclose(np.full(2, np.nan) if gn is None else gn,
                                   n, rtol=0, atol=1e-6)
