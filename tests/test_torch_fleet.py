"""The port's batched paths (parallel/batch.py) against the JAX package on
the CPU (mirrors tests/test_parallel.py:53-92): hypothesis matching and
scoring against one map, and ``fleet_step`` — R robots with a map each —
against JAX ``fleet_step_jit`` and against the port's own ``slam_step``
run robot by robot; plus ``fleet_state_from_numpy`` carrying a JAX fleet
(per-robot or shared map) across.

Tolerances: a fleet's first step from fresh maps has no map to match
against (H = 0, the guard keeps the pose), so poses and maps are held
bit-equal to JAX. Later steps match, and torch sums the moments in
another order than XLA's dot, so poses are held to 1e-5 world units there
(the matcher tests' per-step budget, tests/test_torch_matcher.py) and the
gates exactly. Against the port's own single-robot ``slam_step`` the fleet
is bit-equal: every op is elementwise per robot and ``beam_sum`` reduces
in a fixed order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hector_slam_tpu as hs
from hector_slam_tpu.io.scanlog import LaserModel as JLaser
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.io.scanlog import stack_scans as j_stack
from hector_slam_tpu.parallel.batch import (fleet_step_jit, init_fleet,
                                            match_hypotheses_jit,
                                            residual_for_poses_jit)
from hector_slam_tpu.parallel.shared_map import (init_shared_fleet,
                                                 shared_fleet_step_jit)

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                simulate_trajectory)

LASER_KW = dict(num_beams=181, angle_min=-1.5707964,
                angle_increment=0.017453293, range_min=0.1, range_max=10.0)
MAP_KW = dict(resolution=0.05, size_x=256, size_y=256, levels=2)
JCFG = hs.SlamConfig(map=hs.MapConfig(**MAP_KW), max_beams=256,
                     max_ray_cells=256)
TCFG = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_beams=256,
                     max_ray_cells=256)
JL, TL = JLaser(**LASER_KW), ht.LaserModel(**LASER_KW)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scans(ranges, stack=True):
    """The same ranges as a JAX and a port scan (stacked on a leading
    axis, or one scan)."""
    scale = TCFG.map.level_scale(0)
    if not stack:
        return (j_scan(ranges, scale, JL, JCFG.max_beams),
                ht.scan_from_ranges(ranges, scale, TL, TCFG.max_beams,
                                    device="cpu"))
    return (j_stack([j_scan(r, scale, JL, JCFG.max_beams) for r in ranges]),
            ht.stack_scans([ht.scan_from_ranges(r, scale, TL,
                                                TCFG.max_beams,
                                                device="cpu")
                            for r in ranges]))


def _state_to_numpy(state):
    return ([np.asarray(lo) for lo in state.log_odds],
            np.asarray(state.pose), np.asarray(state.last_map_update_pose),
            np.asarray(state.covariance), np.asarray(state.step),
            np.asarray(state.map_update_count))


@pytest.fixture(scope="module")
def mapped():
    """The fixture of tests/test_parallel.py: a room, 8 corridor poses, a
    map built by the JAX engine from the first 4 scans with known poses,
    and the same map in the port."""
    poses = corridor_trajectory(8, advance=0.05, weave=0.03)
    ranges = simulate_trajectory(World.room(size=10.0), poses, TL)
    jscans = [_scans(r, stack=False)[0] for r in ranges]
    tscans = [_scans(r, stack=False)[1] for r in ranges]
    state = hs.init_state(JCFG)
    for sc, p in zip(jscans[:4], poses[:4]):
        state, _ = hs.slam_step(state, sc, JCFG, pose_hint=jnp.asarray(p),
                                map_without_matching=True)
    tstate = ht.state_from_numpy(*_state_to_numpy(state)[:4],
                                 int(state.step),
                                 int(state.map_update_count), TCFG,
                                 device="cpu")
    return state, tstate, jscans, tscans, poses


def test_match_hypotheses_equals_loop_and_jax(mapped):
    jstate, tstate, jscans, tscans, poses = mapped
    rng = np.random.default_rng(0)
    hyps = (poses[4] + rng.normal(0, 0.05, (16, 3))).astype(np.float32)
    got = ht.match_hypotheses(tstate.log_odds, torch.from_numpy(hyps),
                              tscans[4], TCFG)
    assert got.pose.shape == (16, 3) and got.hessian.shape == (16, 3, 3)
    for i in range(16):
        single = ht.match_pyramid(tstate.log_odds, torch.from_numpy(hyps[i]),
                                  tscans[4], TCFG, quads=tstate.quads)
        np.testing.assert_allclose(got.pose[i].numpy(), single.pose.numpy(),
                                   atol=1e-5)
    want = match_hypotheses_jit(jstate.log_odds, jnp.asarray(hyps),
                                jscans[4], JCFG)
    diff = np.abs(got.pose.numpy() - np.asarray(want.pose)).max(-1)
    assert np.percentile(diff, 90) < 1e-4, diff


def test_best_hypothesis_and_residuals(mapped):
    jstate, tstate, jscans, tscans, poses = mapped
    rng = np.random.default_rng(1)
    hyps = (poses[4] + rng.normal(0, 0.08, (32, 3))).astype(np.float32)
    best_pose, best_h, res = ht.best_hypothesis(
        tstate.log_odds, torch.from_numpy(hyps), tscans[4], TCFG)
    assert np.isfinite(res.numpy()).all() and best_h.shape == (3, 3)
    assert np.linalg.norm(best_pose.numpy()[:2] - poses[4][:2]) < 0.1
    assert int(torch.argmin(res)) == int(np.argmin(res.numpy()))
    # the residual itself, at the same poses in both packages
    want = residual_for_poses_jit(jstate.log_odds[0], jnp.asarray(hyps),
                                  jscans[4], JCFG)
    got = ht.residual_for_poses(tstate.log_odds[0], torch.from_numpy(hyps),
                                tscans[4], TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    coarse = ht.residual_for_poses(tstate.log_odds[1],
                                   torch.from_numpy(hyps), tscans[4], TCFG,
                                   quad=tstate.quads[1], level=1)
    want1 = residual_for_poses_jit(jstate.log_odds[1], jnp.asarray(hyps),
                                   jscans[4], JCFG, level=1)
    np.testing.assert_allclose(coarse.numpy(), np.asarray(want1), rtol=1e-5)


def test_fleet_step_equals_jax(mapped):
    """Mirrors test_fleet_vmap_equals_sequential: four robots, a different
    scan each, one step from fresh maps: poses and every level's map
    bit-equal to JAX fleet_step_jit; then two more steps, gates equal
    and poses within 1e-5."""
    _, _, jscans, tscans, _ = mapped
    r = 4
    jf, tf = init_fleet(JCFG, r), ht.init_fleet(TCFG, r, device="cpu")
    for t in range(3):
        js = j_stack(jscans[t:t + r])
        ts = ht.stack_scans(tscans[t:t + r])
        jf, jm = fleet_step_jit(jf, js, JCFG)
        tf, tm = ht.fleet_step(tf, ts, TCFG)
        np.testing.assert_array_equal(tm.map_updated.numpy(),
                                      np.asarray(jm.map_updated))
        np.testing.assert_array_equal(tm.truncated_free_cells.numpy(),
                                      np.asarray(jm.truncated_free_cells))
        np.testing.assert_array_equal(tf.map_update_count.numpy(),
                                      np.asarray(jf.map_update_count))
        if t == 0:
            assert tm.map_updated.all()
            np.testing.assert_array_equal(tf.pose.numpy(),
                                          np.asarray(jf.pose))
            for a, b in zip(tf.log_odds, jf.log_odds):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(tf.pose.numpy(), np.asarray(jf.pose),
                                       atol=1e-5)
    assert tf.step.tolist() == [3] * r


@pytest.mark.parametrize("model", ["log_odds", "reflectance"])
def test_fleet_equals_single_robot_slam_steps(model):
    """Four robots on their own corridor trajectories (offsets, speeds and
    noise seeds differ): the fleet's robot r is bit-equal to ``slam_step``
    run on robot r alone (poses, gates, every level's map), for the
    default cell model and the two-channel reflectance one."""
    cfg = ht.SlamConfig(map=TCFG.map, max_beams=TCFG.max_beams,
                        max_ray_cells=TCFG.max_ray_cells,
                        update=ht.UpdateConfig(cell_model=model))
    r, steps = 4, 6
    world = World.corridor(length=10.0, width=3.0)
    speeds = (0.05, 0.07, 0.09, 0.12)
    ranges = np.stack([simulate_trajectory(
        world, corridor_trajectory(steps, advance=speeds[i], weave=0.03)
        + np.float32([0.6 * i, 0.0, 0.0]), TL, range_noise_std=0.005,
        seed=10 + i) for i in range(r)], 1)                    # [T, R, B]
    fleet = ht.init_fleet(cfg, r, device="cpu")
    solo = [ht.init_state(cfg, device="cpu") for _ in range(r)]
    gates = np.zeros((steps, r), bool)
    for t in range(steps):
        fleet, m = ht.fleet_step(fleet, _scans(ranges[t])[1], cfg)
        gates[t] = m.map_updated.numpy()
        for i in range(r):
            solo[i], sm = ht.slam_step(solo[i], _scans(ranges[t, i],
                                                       False)[1], cfg)
            assert bool(sm.map_updated) == gates[t, i]
    assert gates[0].all() and 0 < gates[1:].sum() < (steps - 1) * r
    for i in range(r):
        assert torch.equal(fleet.pose[i], solo[i].pose)
        assert torch.equal(fleet.covariance[i], solo[i].covariance)
        for a, b in zip(fleet.log_odds, solo[i].log_odds):
            assert torch.equal(a[i], b)
        for a, b in zip(fleet.quads, solo[i].quads):
            assert torch.equal(a[i], b)
        assert int(fleet.map_update_count[i]) == int(
            solo[i].map_update_count)


@pytest.mark.parametrize("layout", ["per_robot", "shared"])
def test_fleet_state_from_numpy_round_trip(mapped, layout):
    """A JAX fleet state after one step, handed over as numpy, equals
    the JAX leaves in the port, and one more step agrees."""
    _, _, jscans, tscans, poses = mapped
    r = 3
    if layout == "per_robot":
        jstate, _ = fleet_step_jit(init_fleet(JCFG, r),
                                   j_stack(jscans[:r]), JCFG)
        step_j = fleet_step_jit
        step_t = ht.fleet_step
    else:
        starts = np.asarray(poses[:r], np.float32)
        jstate, _ = shared_fleet_step_jit(
            init_shared_fleet(JCFG, r, start_poses=starts),
            j_stack(jscans[:r]), JCFG)
        step_j = shared_fleet_step_jit
        step_t = ht.shared_fleet_step
    fields = _state_to_numpy(jstate)
    tstate = ht.fleet_state_from_numpy(*fields, TCFG, device="cpu")
    for got, want in zip((list(tstate.log_odds),) + tuple(tstate[1:6]),
                         fields):
        for a, b in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            np.testing.assert_array_equal(a.numpy(), b)
    lead = (r,) if layout == "per_robot" else ()
    assert tstate.log_odds[0].shape == lead + (256, 256)
    assert tstate.quads[0].shape == lead + (256 * 256, 4)
    js = j_stack(jscans[r:2 * r])
    ts = ht.stack_scans(tscans[r:2 * r])
    jstate, jm = step_j(jstate, js, JCFG)
    tstate, tm = step_t(tstate, ts, TCFG)
    np.testing.assert_array_equal(tm.map_updated.numpy(),
                                  np.asarray(jm.map_updated))
    np.testing.assert_allclose(tstate.pose.numpy(), np.asarray(jstate.pose),
                               atol=1e-5)
    with pytest.raises(ValueError):
        ht.fleet_state_from_numpy(fields[0], fields[1][:, :2], *fields[2:],
                                  TCFG, device="cpu")
