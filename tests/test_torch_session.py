"""The port's ``SlamSession`` against the JAX package's, on the CPU: the
12-scan corridor log of tests/test_session.py replayed through both
sessions, and each control and product test of that file run against
both packages on the same inputs.

Tolerances: gates (map updates) equal on every scan and equal update
counts; poses within 1e-4 m and 1e-4 rad; occupancy grids equal; the
port's "phases" timing mode bit-equal to its "step" mode (same torch ops
in the same order)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hector_slam_tpu.config import MapConfig as JMapConfig
from hector_slam_tpu.config import SlamConfig as JSlamConfig
from hector_slam_tpu.io.scanlog import LaserModel as JLaserModel
from hector_slam_tpu.io.simulator import (World, corridor_trajectory,
                                          simulate_trajectory)
from hector_slam_tpu.session import SlamSession as JSlamSession

import hector_slam_tpu_torch as ht

POSE_TOL = 1e-4
LASER_KW = dict(num_beams=271, angle_min=-2.356194490192345,
                angle_increment=4 * 0.004363323129985824, range_min=0.1,
                range_max=12.0)
MAP_KW = dict(resolution=0.05, size_x=256, size_y=256, levels=2)
CFG_KW = dict(max_beams=384, max_ray_cells=256)
# tests/test_session.py's small room (save_geotiff, phases timing mode)
ROOM_MAP_KW = dict(resolution=0.1, size_x=128, size_y=128, levels=2)
ROOM_CFG_KW = dict(max_beams=128, max_ray_cells=64)
ROOM_LASER_KW = dict(num_beams=91, angle_min=-1.57, angle_increment=0.0349,
                     range_min=0.1, range_max=5.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def log():
    world = World.corridor(length=8.0, width=3.0)
    poses = corridor_trajectory(12, advance=0.06, weave=0.03)
    return poses, simulate_trajectory(world, poses, JLaserModel(**LASER_KW))


def _pair(map_kw=MAP_KW, cfg_kw=CFG_KW, laser_kw=LASER_KW, jax_kw=None,
          port_kw=None, **kw):
    """(JAX session, port session on the CPU) with the same settings;
    ``jax_kw``/``port_kw`` add per-package arguments (callbacks)."""
    jsess = JSlamSession(JSlamConfig(map=JMapConfig(**map_kw), **cfg_kw),
                         JLaserModel(**laser_kw), **kw, **(jax_kw or {}))
    sess = ht.SlamSession(ht.SlamConfig(map=ht.MapConfig(**map_kw),
                                        **cfg_kw),
                          ht.LaserModel(**laser_kw), device="cpu", **kw,
                          **(port_kw or {}))
    return jsess, sess


def _close_pose(got, want, tol=POSE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got[..., :2] - want[..., :2]).max() <= tol, (got, want)
    assert np.abs(got[..., 2] - want[..., 2]).max() <= tol, (got, want)


def test_session_replay_matches_jax(log):
    """tests/test_session.py::test_session_basic_flow through both
    sessions: gates and update counts equal on every scan, poses and the
    recorded trajectory within 1e-4, the published pose messages and
    the occupancy grid equal."""
    poses, ranges = log
    got_msgs, want_msgs, got_maps, want_maps = [], [], [], []
    jsess, sess = _pair(
        jax_kw=dict(on_pose=want_msgs.append,
                    on_map_update=lambda s: want_maps.append(1)),
        port_kw=dict(on_pose=got_msgs.append,
                     on_map_update=lambda s: got_maps.append(1)))
    for t, r in enumerate(ranges):
        want = jsess.process_ranges(r, stamp=t * 0.025)
        got = sess.process_ranges(r, stamp=t * 0.025)
        _close_pose(got, want)
        assert int(sess.state.map_update_count) == \
            int(jsess.state.map_update_count), t
    assert len(got_maps) == len(want_maps) >= 1
    assert len(got_msgs) == len(want_msgs) == len(ranges)
    for g, w in zip(got_msgs, want_msgs):
        assert g["stamp"] == w["stamp"]
        _close_pose(np.float32(g["position"]), np.float32(w["position"]))
    _close_pose(sess.trajectory.path(), jsess.trajectory.path())
    np.testing.assert_array_equal(sess.occupancy_grid(),
                                  jsess.occupancy_grid())
    np.testing.assert_allclose(sess.covariance, jsess.covariance, rtol=1e-3,
                               atol=1e-2)
    assert sess.covariance.shape == (3, 3)
    st = sess.timing_stats()
    assert st["count"] == len(ranges) and st["p50_ms"] > 0
    assert np.linalg.norm(sess.pose[:2] - poses[len(ranges) - 1][:2]) < 0.12
    assert int(sess.state.step) == len(ranges)


def test_process_points_matches_jax(log):
    """The point-cloud path with its three filters (range window,
    behind-robot cull, z band), through both sessions."""
    _, ranges = log
    laser = ht.LaserModel(**LASER_KW)
    jsess, sess = _pair()
    rng = np.random.default_rng(2)
    for r in ranges[:4]:
        keep = (r > 0.1) & (r < laser.range_max - 0.1)
        ang = laser.angles[keep]
        pts = np.c_[np.cos(ang) * r[keep], np.sin(ang) * r[keep],
                    rng.uniform(-1.5, 1.5, keep.sum())].astype(np.float32)
        kw = dict(origo=(0.1, -0.05), z_min=-1.0, z_max=1.0)
        _close_pose(sess.process_points(pts, **kw),
                    jsess.process_points(pts, **kw))
    np.testing.assert_array_equal(sess.occupancy_grid(),
                                  jsess.occupancy_grid())


def test_session_pause_resume(log):
    _, ranges = log
    for s in _pair():
        s.pause()
        assert s.process_ranges(ranges[0]) is None
        assert int(s.state.step) == 0
        s.resume()
        assert s.process_ranges(ranges[0]) is not None
        assert int(s.state.step) == 1


def test_session_initial_pose_latch(log):
    _, ranges = log
    for s in _pair(map_with_known_poses=True):
        s.set_initial_pose([1.0, 2.0, 0.5 + 2 * np.pi])   # wrapped on entry
        p1 = s.process_ranges(ranges[0])
        np.testing.assert_allclose(p1, [1.0, 2.0, 0.5], atol=1e-6)
        # the latch is consumed: the next scan starts from the last pose
        np.testing.assert_allclose(s.process_ranges(ranges[1]), p1)


def test_session_reset_with_pose(log):
    _, ranges = log
    for s in _pair(map_with_known_poses=True):
        s.process_ranges(ranges[0])
        assert (s.occupancy_grid() != -1).sum() > 0
        s.reset_with_pose([0.5, -0.5, 0.1])
        assert int(s.state.step) == 0
        assert (s.occupancy_grid() == -1).all()
        assert s.timing_stats() == {"count": 0}
        assert len(s.trajectory.path()) == 0
        np.testing.assert_allclose(s.process_ranges(ranges[0]),
                                   [0.5, -0.5, 0.1])
    # the port resets its state in place, on the session's device
    assert all(t.device == torch.device("cpu") for t in s.state.log_odds)


def _state_leaves(state):
    return [*state.log_odds, *state.quads, state.pose,
            state.last_map_update_pose, state.covariance, state.step,
            state.map_update_count]


def test_reset_writes_a_fresh_state_into_the_same_tensors(log):
    """``reset`` and ``reset_with_pose`` write ``init_state``'s values
    into the session's own tensors (the step graph on the card is keyed
    on the maps' memory): every leaf keeps its ``data_ptr`` and equals a
    fresh state's, and the scans after a reset give what a fresh
    session gives, bit for bit."""
    _, ranges = log
    cfg = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), **CFG_KW)
    laser = ht.LaserModel(**LASER_KW)
    sess = ht.SlamSession(cfg, laser, device="cpu")
    for r in ranges[:4]:
        sess.process_ranges(r)
    ptrs = [t.data_ptr() for t in _state_leaves(sess.state)]
    fresh = ht.init_state(cfg, device="cpu")
    for reset in (sess.reset, lambda: sess.reset_with_pose([0.2, 0.1, 0.3])):
        reset()
        assert [t.data_ptr() for t in _state_leaves(sess.state)] == ptrs
        for got, want in zip(_state_leaves(sess.state), _state_leaves(fresh)):
            assert torch.equal(got, want)
        fresh_sess = ht.SlamSession(cfg, laser, device="cpu")
        if sess._initial_pose is not None:
            fresh_sess.set_initial_pose([0.2, 0.1, 0.3])
        for r in ranges[:3]:
            np.testing.assert_array_equal(sess.process_ranges(r),
                                          fresh_sess.process_ranges(r))
        for got, want in zip(_state_leaves(sess.state),
                             _state_leaves(fresh_sess.state)):
            assert torch.equal(got, want)
        ptrs = [t.data_ptr() for t in _state_leaves(sess.state)]
    # a state whose leaves share memory is replaced, not written through
    st = sess.state
    sess.state = st._replace(last_map_update_pose=st.pose)
    sess.reset()
    for got, want in zip(_state_leaves(sess.state), _state_leaves(fresh)):
        assert torch.equal(got, want)


def test_session_map_publication_gating(log):
    _, ranges = log
    for s in _pair():
        s.process_ranges(ranges[0])
        assert s.occupancy_grid(only_if_changed=True) is not None
        assert s.occupancy_grid(only_if_changed=True) is None
        assert s.occupancy_grid() is not None


def test_session_z_band_filter():
    pts = np.asarray([[1.0, 0.0, 0.5], [1.0, 0.5, 3.0]], np.float32)
    for s in _pair(map_with_known_poses=True):
        s.process_points(pts, z_min=0.0, z_max=1.0)
        assert (s.occupancy_grid() == 100).sum() == 1


def test_slam_cloud(log):
    """tests/test_session.py::test_slam_cloud: both frames, both
    packages, and the clouds equal."""
    _, ranges = log
    jsess, sess = _pair()
    clouds = []
    for s in (jsess, sess):
        with pytest.raises(ValueError):
            s.slam_cloud()
        for t, r in enumerate(ranges):
            s.process_ranges(r, stamp=t * 0.025)
        cloud_b = s.slam_cloud(frame="base")
        cloud_m = s.slam_cloud(frame="map")
        pose = s.pose
        c, sn = np.cos(pose[2]), np.sin(pose[2])
        np.testing.assert_allclose(
            cloud_m, np.c_[pose[0] + c * cloud_b[:, 0] - sn * cloud_b[:, 1],
                           pose[1] + sn * cloud_b[:, 0] + c * cloud_b[:, 1]],
            atol=1e-5)
        assert len(cloud_b) > 100
        wall = np.abs(np.abs(cloud_m[:, 1]) - 1.5) < 0.2
        assert wall.mean() > 0.5, wall.mean()
        with pytest.raises(ValueError):
            s.slam_cloud(frame="laser0")
        clouds.append((cloud_b, cloud_m))
    np.testing.assert_array_equal(clouds[1][0], clouds[0][0])
    np.testing.assert_allclose(clouds[1][1], clouds[0][1], atol=2e-4)


def test_scanmatch_odom(log):
    _, ranges = log
    msgs = []
    for s in _pair():
        for t, r in enumerate(ranges):
            s.process_ranges(r, stamp=1000.0 + t * 0.025)
        odom = s.scanmatch_odom()
        assert odom["frame_id"] == "map"
        assert odom["child_frame_id"] == "base_link"
        assert odom["stamp"] == 1000.0 + (len(ranges) - 1) * 0.025
        np.testing.assert_allclose(odom["position"][:2], s.pose[:2],
                                   atol=1e-6)
        assert odom["covariance"].shape == (6, 6)
        np.testing.assert_array_equal(odom["twist"], np.zeros(6))
        msgs.append(odom)
    assert msgs[0].keys() == msgs[1].keys()
    _close_pose(np.float32(msgs[1]["position"]),
                np.float32(msgs[0]["position"]))


def test_odom_start_estimate(log):
    """pose_hint_from_odom and process_ranges(odom_pose=), both
    packages."""
    poses, ranges = log
    for s in _pair():
        assert s.pose_hint_from_odom([0.0, 0.0, 0.0]) is None
        pose = np.asarray([1.0, 2.0, np.pi / 2], np.float32)
        if isinstance(s, ht.SlamSession):
            s.state = s.state._replace(pose=torch.from_numpy(pose))
        else:
            s.state = s.state._replace(pose=jnp.asarray(pose))
        hint = s.pose_hint_from_odom([0.1, 0.0, 0.0])
        np.testing.assert_allclose(hint, [1.0, 2.1, np.pi / 2], atol=1e-5)
    jsess, sess = _pair()
    for p, r in zip(poses, ranges):
        _close_pose(sess.process_ranges(r, odom_pose=p),
                    jsess.process_ranges(r, odom_pose=p))
    assert np.linalg.norm(sess.pose[:2] - poses[len(ranges) - 1][:2]) < 0.12


def test_geotiff_autosave(log, tmp_path):
    """Periodic geotiff autosave on scan-stamp time, both packages: the
    same files, byte for byte; none when disabled."""
    _, ranges = log
    bases = [str(tmp_path / "jax_auto"), str(tmp_path / "port_auto")]
    jsess = JSlamSession(JSlamConfig(map=JMapConfig(**MAP_KW), **CFG_KW),
                         JLaserModel(**LASER_KW), geotiff_save_period=0.1,
                         geotiff_base_path=bases[0])
    sess = ht.SlamSession(ht.SlamConfig(map=ht.MapConfig(**MAP_KW), **CFG_KW),
                          ht.LaserModel(**LASER_KW), geotiff_save_period=0.1,
                          geotiff_base_path=bases[1], device="cpu")
    for s in (jsess, sess):
        for t, r in enumerate(ranges):
            s.process_ranges(r, stamp=t * 0.025)
    for ext in (".png", ".tfw"):
        assert os.path.exists(bases[1] + ext)
    with open(bases[0] + ".tfw") as a, open(bases[1] + ".tfw") as b:
        assert a.read() == b.read()
    quiet = str(tmp_path / "quiet")
    _, off = _pair(geotiff_base_path=quiet)
    for t, r in enumerate(ranges[:3]):
        off.process_ranges(r, stamp=t * 0.025)
    assert not os.path.exists(quiet + ".png")


def test_phases_timing_mode_bit_equal_to_step():
    """tests/test_session.py::test_phases_timing_mode_identical_results:
    in the port, "phases" runs the same torch ops in the same order as
    "step", so poses and maps are bit-equal (JAX: within 1e-5, two
    programs); both report per-phase times."""
    poses = corridor_trajectory(5, advance=0.05, weave=0.0)
    ranges = simulate_trajectory(World.room(size=5.0), poses,
                                 JLaserModel(**ROOM_LASER_KW))
    kw = dict(map_kw=ROOM_MAP_KW, cfg_kw=ROOM_CFG_KW, laser_kw=ROOM_LASER_KW)
    j_step, p_step = _pair(**kw)
    j_phases, p_phases = _pair(timing_mode="phases", **kw)
    for r in ranges:
        a = p_step.process_ranges(r)
        np.testing.assert_array_equal(p_phases.process_ranges(r), a)
        np.testing.assert_allclose(j_phases.process_ranges(r),
                                   j_step.process_ranges(r), rtol=1e-5,
                                   atol=1e-5)
        _close_pose(a, j_step.pose)
    for a, b in zip(p_step.state.log_odds, p_phases.state.log_odds):
        assert torch.equal(a, b)
    for s_step, s_phases in ((j_step, j_phases), (p_step, p_phases)):
        st = s_phases.timing_stats()
        assert st["count"] == 5
        for k in ("match_p50_ms", "update_p50_ms", "match_mean_ms",
                  "update_mean_ms"):
            assert st[k] >= 0.0
        assert "match_p50_ms" not in s_step.timing_stats()
    with pytest.raises(ValueError):
        ht.SlamSession(device="cpu", timing_mode="bogus")


def test_session_needs_a_card_unless_asked_for_the_cpu():
    """The session defaults to the card and raises without one; every
    tensor it makes lies on the device it was given."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.SlamSession(ht.SlamConfig(map=ht.MapConfig(**MAP_KW), **CFG_KW))
    sess = ht.SlamSession(ht.SlamConfig(map=ht.MapConfig(**MAP_KW),
                                        **CFG_KW), device="cpu")
    assert sess.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in
               (*sess.state.log_odds, *sess.state.quads, sess.state.pose))


def test_profile_trace_writes_a_trace(log, tmp_path):
    _, ranges = log
    _, sess = _pair()
    with sess.profile_trace(str(tmp_path / "trace")):
        sess.process_ranges(ranges[0])
    files = os.listdir(tmp_path / "trace")
    assert any(f.endswith(".json") or f.endswith(".json.gz") for f in files)
