"""Parity of the port's Gauss-Newton matcher with the JAX package on the
CPU (mirrors tests/test_matcher.py): single GN steps, the dtheta clamp,
the H guard, one level, the empty-scan rule and the pyramid chain.

Both packages get the same f32 inputs. The moments differ only in f32
summation order (torch sums nine elementwise products over the beams,
XLA contracts with a dot), so poses are held to 1e-4 map cells per GN
step and Hessians to 1e-5 of their largest entry; discrete outcomes
(guard, clamp, empty scan) are held exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hector_slam_tpu.config import MapConfig, SlamConfig
from hector_slam_tpu.core import matcher as jm
from hector_slam_tpu.core.interp import quad_pack_storage as jquad
from hector_slam_tpu.oracle import oracle_np as on
from hector_slam_tpu.types import Scan as JScan

import hector_slam_tpu_torch.config as tcfg
from hector_slam_tpu_torch.core import matcher as tm
from hector_slam_tpu_torch.core.interp import quad_pack_storage as tquad
from hector_slam_tpu_torch.types import Scan as TScan


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def T(a):
    return torch.from_numpy(np.array(a))


def _world_with_wall(size=64, res=0.1):
    off = (res * size * 0.5, res * size * 0.5)
    m = on.OracleMap(size, size, res, off)
    m.log_odds[10:54, 44] = 2.0
    m.log_odds[12, 10:50] = 2.0
    return m, off


def _scan_hitting_wall(m, pose_true, n=80):
    ys = np.linspace(12.0, 52.0, n // 2)
    xs = np.linspace(11.0, 49.0, n - n // 2)
    pts_map = np.concatenate([np.stack([np.full_like(ys, 44.0), ys], -1),
                              np.stack([xs, np.full_like(xs, 12.0)], -1)])
    pm = m.world_to_map_pose(pose_true)
    c, s = np.cos(pm[2]), np.sin(pm[2])
    rel = pts_map - pm[:2]
    return np.stack([c * rel[:, 0] + s * rel[:, 1],
                     -s * rel[:, 0] + c * rel[:, 1]], -1).astype(np.float32)


def _both_quads(lo):
    lo = np.asarray(lo, np.float32)
    return ((jquad(jnp.asarray(lo), "log_odds"), lo.shape),
            (tquad(T(lo), "log_odds"), lo.shape))


def _close(t, j, pose_tol=1e-4, rel_h=1e-5):
    tp, th = (a.numpy() for a in t)
    jp, jh = (np.asarray(a) for a in j)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=pose_tol)
    scale = max(np.abs(jh).max(), 1e-30)
    assert np.abs(th - jh).max() <= rel_h * scale


@pytest.mark.parametrize("offset,start_delta", [
    ("near", (0.08, -0.05, 0.04)),
    ("wide_angle", (0.0, 0.0, 0.8)),
])
def test_gn_step_matches_jax(offset, start_delta):
    m, _ = _world_with_wall()
    pose_true = np.array([0.3, -0.2, 0.15] if offset == "near"
                         else [0.0, 0.0, 0.0], np.float32)
    pts = _scan_hitting_wall(m, pose_true)
    est = m.world_to_map_pose(pose_true + np.array(start_delta, np.float32))
    est = np.asarray(est, np.float32)
    (jq, shape), (tq, _) = _both_quads(m.log_odds)
    mask = np.ones(len(pts), bool)
    j = jm.gn_step(jq, shape, jnp.asarray(est), jnp.asarray(pts),
                   jnp.asarray(mask))
    t = tm.gn_step(tq, shape, T(est), T(pts), T(mask))
    _close(t, j)


def test_guarded_step_clamp_and_guard():
    """dtheta is clamped to +-0.2 (ScanMatcher.h:209-215); a zero H(0,0)
    or H(1,1) leaves the estimate unchanged (ScanMatcher.h:201)."""
    est = T(np.array([[10.0, 20.0, 0.5]] * 3, np.float32))
    h = torch.eye(3).repeat(3, 1, 1)
    h[2, 1, 1] = 0.0
    dtr = T(np.array([[0.1, -0.2, 0.7], [0.0, 0.0, -0.9],
                      [1.0, 1.0, 1.0]], np.float32))
    new = tm.guarded_step(est, h, dtr).numpy()
    np.testing.assert_array_equal(new[0], np.float32([10.0, 20.0, 0.5])
                                  + np.float32([0.1, -0.2, 0.2]))
    np.testing.assert_array_equal(new[1], np.float32([10.0, 20.0, 0.5])
                                  + np.float32([0.0, 0.0, -0.2]))
    np.testing.assert_array_equal(new[2], est[2].numpy())


def test_gn_guard_zero_hessian():
    lo = np.zeros((32, 32), np.float32)
    est = np.array([16.0, 16.0, 0.0], np.float32)
    pts = np.random.default_rng(0).uniform(-5, 5, (20, 2)).astype(np.float32)
    (_, shape), (tq, _) = _both_quads(lo)
    new_est, h = tm.gn_step(tq, shape, T(est), T(pts),
                            torch.ones(20, dtype=torch.bool))
    np.testing.assert_array_equal(new_est.numpy(), est)
    assert (h.numpy() == 0.0).all()


def test_match_level_matches_jax():
    m, off = _world_with_wall()
    pose_true = np.array([0.25, -0.15, 0.1], np.float32)
    pts = _scan_hitting_wall(m, pose_true)
    begin = pose_true + np.array([0.06, 0.04, -0.05], np.float32)
    (jq, shape), (tq, _) = _both_quads(m.log_odds)
    mask = np.ones(len(pts), bool)
    j = jm.match_level(jq, shape, jnp.asarray(begin), jnp.asarray(pts),
                       jnp.asarray(mask), 5, off, 10.0, 0.1)
    t = tm.match_level(tq, shape, T(begin), T(pts), T(mask), 5, off, 10.0,
                       0.1)
    # world poses: 1e-4 map cells of 0.1 m after 6 steps
    _close(t, j, pose_tol=1e-4)
    assert np.linalg.norm(t[0].numpy()[:2] - pose_true[:2]) < \
        np.linalg.norm(begin[:2] - pose_true[:2])


def test_match_level_empty_scan_returns_input():
    (_, shape), (tq, _) = _both_quads(np.zeros((32, 32), np.float32))
    begin = T(np.array([1.0, 2.0, 3.0], np.float32))
    pose, h = tm.match_level(tq, shape, begin, torch.zeros((16, 2)),
                             torch.zeros(16, dtype=torch.bool), 5,
                             (1.6, 1.6), 10.0, 0.1)
    assert torch.equal(pose, begin)
    assert (h == 0.0).all()


def test_match_pyramid_matches_jax():
    size, res = 64, 0.1
    mm = on.OracleMultiMap(res, size, size, 3)
    for lvl, m in enumerate(mm.maps):
        f = 2 ** lvl
        m.log_odds[10 // f + 1:54 // f, 44 // f] = 2.0
        m.log_odds[12 // f, 10 // f + 1:50 // f] = 2.0
    pose_true = np.array([0.3, -0.1, 0.05], np.float32)
    pts = _scan_hitting_wall(mm.maps[0], pose_true)
    begin = pose_true + np.array([0.07, -0.06, 0.06], np.float32)
    n_pad = 128
    padded = np.zeros((n_pad, 2), np.float32)
    padded[: len(pts)] = pts
    mask = np.arange(n_pad) < len(pts)
    jc = SlamConfig(map=MapConfig(resolution=res, size_x=size, size_y=size,
                                  levels=3), max_ray_cells=128)
    tc = tcfg.SlamConfig(map=tcfg.MapConfig(resolution=res, size_x=size,
                                            size_y=size, levels=3),
                         max_ray_cells=128)
    pyr = [np.asarray(m.log_odds, np.float32) for m in mm.maps]
    j = jm.match_pyramid(tuple(jnp.asarray(p) for p in pyr),
                         jnp.asarray(begin),
                         JScan(jnp.asarray(padded), jnp.zeros(2, jnp.float32),
                               jnp.asarray(mask)), jc)
    t = tm.match_pyramid(tuple(T(p) for p in pyr), T(begin),
                         TScan(T(padded), torch.zeros(2), T(mask)), tc)
    _close(t, j, pose_tol=1e-4)
    want_pose, _ = mm.match_data(begin, pts)
    np.testing.assert_allclose(t.pose.numpy(), want_pose, atol=1e-3)
