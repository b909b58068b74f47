"""The port's host-side exports and helpers against the JAX package's, on
the same numpy inputs: pose algebra, point-cloud scans and scan logs,
the cell models' occupancy classification, occupancy grids and their
metadata, pose output, the trajectory server's recovery query, and the
geotiff writer's PNG and TFW bytes.

Tolerance: bit-equal throughout (the port keeps numpy copies of the
numpy modules, and the classifications are comparisons on equal f32
storage)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hector_slam_tpu.config import MapConfig as JMapConfig
from hector_slam_tpu.config import SlamConfig as JSlamConfig
from hector_slam_tpu.core import cell_models as jcm
from hector_slam_tpu.core import pose2d as jpose2d
from hector_slam_tpu.export import geotiff as jgeotiff
from hector_slam_tpu.export import occupancy as jocc
from hector_slam_tpu.export import pose_output as jpo
from hector_slam_tpu.export.trajectory import \
    TrajectoryRecorder as JTrajectoryRecorder
from hector_slam_tpu.io import scanlog as jscanlog
from hector_slam_tpu.io.simulator import (World, corridor_trajectory,
                                          simulate_trajectory)
from hector_slam_tpu.session import SlamSession as JSlamSession

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import cell_models as tcm
from hector_slam_tpu_torch.core import pose2d as tpose2d
from hector_slam_tpu_torch.export.trajectory import TrajectoryRecorder

MODELS = ("log_odds", "simple_count", "reflectance")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_pose2d_algebra_matches_jax():
    """tests/test_session.py::test_pose2d_algebra against both packages,
    then every function bit-equal on random poses."""
    a = np.asarray([1.0, 2.0, np.pi / 2])
    b = np.asarray([1.0, 0.0, 0.1])
    c = tpose2d.compose(a, b)
    np.testing.assert_allclose(c, [1.0, 3.0, np.pi / 2 + 0.1], atol=1e-12)
    np.testing.assert_allclose(tpose2d.compose(a, tpose2d.invert(a)),
                               [0, 0, 0], atol=1e-12)
    map_base = np.asarray([2.0, 1.0, 0.7])
    odom_base = np.asarray([0.5, -0.2, 0.3])
    m2o = tpose2d.map_to_odom(map_base, odom_base)
    np.testing.assert_allclose(tpose2d.compose(m2o, odom_base), map_base,
                               atol=1e-12)
    rng = np.random.default_rng(4)
    for _ in range(10):
        p, q = rng.uniform(-3, 3, 3), rng.uniform(-3, 3, 3)
        for name in ("compose", "map_to_odom", "map_to_odom_transform"):
            _equal(getattr(tpose2d, name)(p, q), getattr(jpose2d, name)(p, q))
        _equal(tpose2d.invert(p), jpose2d.invert(p))
        _equal(tpose2d.transform_point(p, q[:2]),
               jpose2d.transform_point(p, q[:2]))


def test_map_to_odom_transform_roundtrip():
    """tests/test_session.py::test_map_to_odom_transform on the port."""
    rng = np.random.default_rng(4)
    for _ in range(10):
        pose = rng.uniform(-3, 3, 3)
        odom = rng.uniform(-3, 3, 3)
        m2o = tpose2d.map_to_odom_transform(pose, odom)
        c, s = np.cos(m2o[2]), np.sin(m2o[2])
        np.testing.assert_allclose(
            [m2o[0] + c * odom[0] - s * odom[1],
             m2o[1] + s * odom[0] + c * odom[1], m2o[2] + odom[2]], pose,
            atol=1e-5)


@pytest.mark.parametrize("origo", [(0.0, 0.0), (0.13, -0.07)])
def test_scan_from_points_matches_jax(origo):
    """Points and origo scaled to map units, the range window and the
    behind-robot cull: every field bit-equal."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-8, 8, (400, 2)).astype(np.float32)
    pts[:20] *= 0.05        # inside min_dist and the behind-robot cull
    want = jscanlog.scan_from_points(pts, 20.0, 512, origo)
    got = ht.scan_from_points(pts, 20.0, 512, origo, device="cpu")
    for g, w in zip(got, want):
        _equal(g.numpy(), w)
    with pytest.raises(ValueError):
        ht.scan_from_points(pts, 20.0, 16, device="cpu")
    with pytest.raises(RuntimeError):
        ht.scan_from_points(pts, 20.0, 512)   # no card here


def test_save_log_load_log_roundtrip(tmp_path):
    """A log written by the port reads back equal through both packages'
    load_log, and one written by JAX through the port's."""
    rng = np.random.default_rng(1)
    ranges = rng.uniform(0.2, 9.0, (5, 91)).astype(np.float32)
    truth = rng.normal(size=(5, 3)).astype(np.float32)
    laser = ht.LaserModel(num_beams=91, angle_min=-1.5, angle_increment=0.03,
                          range_min=0.1, range_max=10.0)
    ht.save_log(str(tmp_path / "port.npz"), ranges, truth, laser)
    jscanlog.save_log(str(tmp_path / "jax.npz"), ranges, truth,
                      jscanlog.LaserModel(**vars(laser)))
    for path in ("port.npz", "jax.npz"):
        got = ht.load_log(str(tmp_path / path))
        want = jscanlog.load_log(str(tmp_path / path))
        _equal(got[0], want[0])
        _equal(got[0], ranges)
        _equal(got[2], want[2])
        assert vars(got[1]) == vars(want[1]) == vars(laser)
    ht.save_log(str(tmp_path / "bare.npz"), ranges)
    assert ht.load_log(str(tmp_path / "bare.npz"))[2] is None


def _storage(model, rng, shape=(48, 40)):
    """f32 storage with exact threshold values among random ones."""
    if model == "log_odds":
        s = rng.normal(0, 1, shape).astype(np.float32)
        s[rng.random(shape) < 0.3] = 0.0
    elif model == "simple_count":
        s = rng.random(shape).astype(np.float32)
        s[rng.random(shape) < 0.3] = 0.5
    else:
        visited = rng.integers(0, 4, shape).astype(np.float32)
        reflected = np.minimum(rng.integers(0, 3, shape), visited)
        s = np.stack([visited, reflected.astype(np.float32)])
    return s


@pytest.mark.parametrize("model", MODELS)
def test_cell_classification_and_occupancy_grid_match_jax(model):
    rng = np.random.default_rng(3)
    s = _storage(model, rng)
    t = torch.from_numpy(s)
    _equal(tcm.is_free(t, model).numpy(), jcm.is_free(jnp.asarray(s), model))
    _equal(tcm.is_occupied(t, model).numpy(),
           jcm.is_occupied(jnp.asarray(s), model))
    want = jocc.to_occupancy_grid(s, model)
    _equal(ht.to_occupancy_grid(t, model), want)
    _equal(ht.to_occupancy_grid(s, model), want)   # numpy in, as JAX takes
    _equal(ht.to_occupancy_grid_tensor(t, model).numpy(), want)
    assert set(np.unique(want)) == {-1, 0, 100}
    with pytest.raises(ValueError):
        tcm.is_free(t, "bogus")


@pytest.mark.parametrize("levels,start", [(2, (0.5, 0.5)), (3, (0.75, 0.25))])
def test_grid_meta_and_map_extends_match_jax(levels, start):
    mcfg = ht.MapConfig(resolution=0.05, size_x=96, size_y=64, levels=levels,
                        start_coords=start)
    jcfg = JMapConfig(resolution=0.05, size_x=96, size_y=64, levels=levels,
                      start_coords=start)
    for level in range(levels):
        got, want = ht.grid_meta(mcfg, level), jocc.grid_meta(jcfg, level)
        assert got == ht.GridMeta(**vars(want))
        xy = np.asarray([[1.25, -0.5], [3.0, 2.0]], np.float32)
        _equal(got.world_to_map(xy), want.world_to_map(xy))
        _equal(got.map_to_world(xy), want.map_to_world(xy))
    occ = np.full((64, 96), -1, np.int8)
    assert ht.map_extends(occ) is None is jocc.map_extends(occ)
    occ[5:9, 30] = 0
    occ[12, 70] = 100
    assert ht.map_extends(occ) == jocc.map_extends(occ) == ((30, 5), (71, 13))


def test_pose_output_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(5):
        pose = rng.normal(size=3).astype(np.float32)
        cov = rng.normal(size=(3, 3)).astype(np.float32)
        got, want = ht.pose_stamped(pose, cov, 12.5), jpo.pose_stamped(
            pose, cov, 12.5)
        assert got.keys() == want.keys()
        for k in got:
            _equal(got[k], want[k])
        _equal(ht.covariance_6x6(cov), jpo.covariance_6x6(cov))
        _equal(ht.covariance_world_coords(cov, 0.05),
               jpo.covariance_world_coords(cov, 0.05))
        q = ht.yaw_to_quaternion(float(pose[2]))
        assert q == jpo.yaw_to_quaternion(float(pose[2]))
        assert ht.quaternion_to_yaw(q) == jpo.quaternion_to_yaw(q)


def test_trajectory_recovery_info_matches_jax():
    """GetRecoveryInfo on both recorders fed the same poses, including a
    duplicate stamp (dropped), requests before, inside and past the
    stored times, and radii the trajectory never leaves."""
    rng = np.random.default_rng(6)
    poses = np.cumsum(rng.normal(0, 0.2, (40, 3)), 0).astype(np.float32)
    stamps = np.arange(40) * 0.1
    stamps[7] = stamps[6]
    port, jax_rec = TrajectoryRecorder(), JTrajectoryRecorder()
    assert port.recovery_info(1.0, 1.0) is None is jax_rec.recovery_info(
        1.0, 1.0)
    for t, p in zip(stamps, poses):
        port.add(float(t), p)
        jax_rec.add(float(t), p)
    _equal(port.path(), jax_rec.path())
    for req in (-1.0, 0.0, 1.05, 2.5, 3.9, 10.0):
        for radius in (0.1, 0.5, 2.0, 100.0):
            got = port.recovery_info(req, radius)
            want = jax_rec.recovery_info(req, radius)
            assert (got is None) == (want is None), (req, radius)
            if got is not None:
                for f in ("req_pose", "radius_entry_pose", "trajectory"):
                    _equal(getattr(got, f), getattr(want, f))
    port.reset()
    assert len(port.path()) == 0


def test_write_geotiff_bytes_match_jax(tmp_path):
    """The same occupancy grid, trajectory and objects give the same PNG
    and TFW bytes from both writers."""
    rng = np.random.default_rng(8)
    occ = np.full((128, 160), -1, np.int8)
    occ[20:100, 30:140] = 0
    occ[rng.random(occ.shape) < 0.02] = 100
    mcfg = ht.MapConfig(resolution=0.05, size_x=160, size_y=128, levels=1)
    meta = ht.grid_meta(mcfg)
    jmeta = jocc.grid_meta(JMapConfig(resolution=0.05, size_x=160,
                                      size_y=128, levels=1))
    path = np.c_[np.linspace(-1, 2, 30), np.linspace(-0.5, 0.8, 30),
                 np.zeros(30)].astype(np.float32)
    objects = [((0.5, 0.2), "victim 1"), ((-0.8, 0.4), "qr", (255, 0, 0),
                                           "diamond")]
    got = ht.write_geotiff(occ, meta, str(tmp_path / "port"), path,
                           objects=objects)
    want = jgeotiff.write_geotiff(occ, jmeta, str(tmp_path / "jax"), path,
                                  objects=objects)
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()


def test_session_save_geotiff_bytes_match_jax(tmp_path):
    """tests/test_session.py::test_session_save_geotiff through both
    sessions with known poses: equal maps, so equal PNG and TFW bytes."""
    jcfg = JSlamConfig(map=JMapConfig(resolution=0.1, size_x=128,
                                      size_y=128, levels=2),
                       max_beams=128, max_ray_cells=64)
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.1, size_x=128,
                                         size_y=128, levels=2),
                        max_beams=128, max_ray_cells=64)
    kw = dict(num_beams=91, angle_min=-1.57, angle_increment=0.0349,
              range_min=0.1, range_max=5.0)
    jsess = JSlamSession(jcfg, jscanlog.LaserModel(**kw),
                         map_with_known_poses=True)
    sess = ht.SlamSession(cfg, ht.LaserModel(**kw),
                          map_with_known_poses=True, device="cpu")
    poses = corridor_trajectory(3, advance=0.05, weave=0.0)
    for t, (p, r) in enumerate(zip(poses, simulate_trajectory(
            World.room(size=5.0), poses, jscanlog.LaserModel(**kw)))):
        _equal(sess.process_ranges(r, stamp=0.025 * t, pose_hint=p),
               jsess.process_ranges(r, stamp=0.025 * t, pose_hint=p))
    _equal(sess.occupancy_grid(), jsess.occupancy_grid())
    got = sess.save_geotiff(str(tmp_path / "port_map"))
    want = jsess.save_geotiff(str(tmp_path / "jax_map"))
    for g, w in zip(got, want):
        assert os.path.exists(g)
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()
