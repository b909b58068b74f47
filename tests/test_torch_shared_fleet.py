"""The port's shared-map fleet (parallel/shared_map.py) against JAX
``shared_fleet_step_jit`` on the CPU (mirrors tests/test_parallel.py:
283-375), and the committed 64-robot JAX reference that chip_smoke.py
holds the card to (tests/fixtures/shared_fleet_jax_reference.npz, written
by tools/make_torch_fleet_reference.py).

The robots scan with the full 1081-beam laser: with many beams the GN
iterates are well conditioned, so the packages' f32 summation orders move
poses by ~1e-6 m and no map cell flips. Held: gates and update counts
exactly, pose RMSE against JAX < 1e-4 m, and each level's counts of cells
> 0 and < 0 equal. The pose limit sits between the readings here (1.7e-6
m for the room fleet, 1.3e-7 m for the fresh small reference) and a
control with one GN step fewer on the finest level (1.6e-2 m on the fresh
small reference, its gates still equal); chip_smoke.py holds the card to
the same limit."""

import os

import numpy as np
import pytest
import torch

import hector_slam_tpu as hs
from hector_slam_tpu.io.scanlog import LaserModel as JLaser
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.io.scanlog import stack_scans as j_stack
from hector_slam_tpu.parallel.shared_map import (init_shared_fleet,
                                                 shared_fleet_step_jit)

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.io.simulator import World, simulate_trajectory
from tools import make_torch_fleet_reference as mfr

MAP_KW = dict(resolution=0.05, size_x=256, size_y=256, levels=2)
JCFG = hs.SlamConfig(map=hs.MapConfig(**MAP_KW), max_ray_cells=256)
TCFG = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_ray_cells=256)
RMSE_BUDGET_M = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scans(ranges, cfg_t=TCFG, cfg_j=JCFG):
    scale = cfg_t.map.level_scale(0)
    return (j_stack([j_scan(r, scale, JLaser(), cfg_j.max_beams)
                     for r in ranges]),
            ht.stack_scans([ht.scan_from_ranges(r, scale, ht.LaserModel(),
                                                cfg_t.max_beams,
                                                device="cpu")
                            for r in ranges]))


def _counts(levels):
    return ([int((np.asarray(lo) > 0).sum()) for lo in levels],
            [int((np.asarray(lo) < 0).sum()) for lo in levels])


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a)[..., :2]
                                  - np.asarray(b)[..., :2]) ** 2)))


def test_shared_map_fleet_room():
    """Four robots from known start poses in a common frame, each driving
    forward on its own heading inside a cluttered room, tracking against
    and integrating into ONE pyramid: held against JAX step by step, and
    to the JAX test's own checks (ground-truth error, one consistent wall
    set, a lone robot tracks as well)."""
    r, steps, advance = 4, 12, 0.05
    world = World.room(size=10.0)
    starts = np.asarray([[-2.0, -2.0, 0.6], [2.0, -2.0, 2.2],
                         [2.0, 2.0, -2.4], [-2.0, 2.0, -0.6]], np.float32)
    head = np.stack([np.cos(starts[:, 2]), np.sin(starts[:, 2]),
                     np.zeros(r, np.float32)], axis=-1)
    true_poses = np.stack([starts + t * advance * head
                           for t in range(steps)]).astype(np.float32)
    jstate = init_shared_fleet(JCFG, r, start_poses=starts)
    tstate = ht.init_shared_fleet(TCFG, r, start_poses=starts, device="cpu")
    jp, tp = [], []
    for t in range(steps):
        ranges = simulate_trajectory(world, true_poses[t], ht.LaserModel(),
                                     range_noise_std=0.003, seed=t)
        js, ts = _scans(ranges)
        jstate, jm = shared_fleet_step_jit(jstate, js, JCFG)
        tstate, tm = ht.shared_fleet_step(tstate, ts, TCFG)
        assert tm.map_updated.shape == (r,)
        np.testing.assert_array_equal(tm.map_updated.numpy(),
                                      np.asarray(jm.map_updated))
        assert int(tm.truncated_free_cells) == int(jm.truncated_free_cells)
        assert int(tstate.map_update_count) == int(jstate.map_update_count)
        jp.append(np.asarray(jstate.pose))
        tp.append(tstate.pose.numpy())
    assert int(tstate.map_update_count) >= 2
    assert _rmse(tp, jp) < RMSE_BUDGET_M
    assert _counts(tstate.log_odds) == _counts(jstate.log_odds)

    err = np.linalg.norm(tp[-1][:, :2] - true_poses[-1][:, :2], axis=1)
    assert (err < 0.12).all(), err
    occ = int((tstate.log_odds[0] > 0).sum())
    assert 400 < occ < 3000, occ

    lone = ht.init_shared_fleet(TCFG, 1, start_poses=starts[:1],
                                device="cpu")
    for t in range(steps):
        ranges = simulate_trajectory(world, true_poses[t][:1],
                                     ht.LaserModel(),
                                     range_noise_std=0.003, seed=t)
        lone, _ = ht.shared_fleet_step(lone, _scans(ranges)[1], TCFG)
    assert np.linalg.norm(lone.pose.numpy()[0, :2]
                          - true_poses[-1][0, :2]) < 0.12


def test_shared_map_fleet_per_robot_gating():
    """Per-robot gates fire independently: the first step maps (FLT_MAX
    gate pose); then a robot moved past the 0.4 m gate maps while a
    stationary one does not; with nobody moving no gate fires and the
    shared update count stays. Gates equal JAX's at every step."""
    world = World.room(size=10.0)
    starts = np.asarray([[-2.0, -2.0, 0.6], [2.0, 2.0, -2.4]], np.float32)
    jstate = init_shared_fleet(JCFG, 2, start_poses=starts)
    tstate = ht.init_shared_fleet(TCFG, 2, start_poses=starts, device="cpu")

    def step(poses, t):
        nonlocal jstate, tstate
        ranges = simulate_trajectory(world, poses, ht.LaserModel(),
                                     range_noise_std=0.002, seed=t)
        js, ts = _scans(ranges)
        jstate, jm = shared_fleet_step_jit(jstate, js, JCFG)
        tstate, tm = ht.shared_fleet_step(tstate, ts, TCFG)
        np.testing.assert_array_equal(tm.map_updated.numpy(),
                                      np.asarray(jm.map_updated))
        return tm.map_updated.numpy()

    assert step(starts, 0).all(), "first scan maps (FLT_MAX)"
    count1 = int(tstate.map_update_count)
    moved = starts.copy()
    moved[0, 0] += 0.45 * np.cos(starts[0, 2])
    moved[0, 1] += 0.45 * np.sin(starts[0, 2])
    assert step(moved, 1).tolist() == [True, False]
    assert int(tstate.map_update_count) == count1 + 1
    quads = tstate.quads
    assert not step(moved, 2).any()
    assert int(tstate.map_update_count) == count1 + 1
    assert all(torch.equal(a, b) for a, b in zip(tstate.quads, quads))
    assert _counts(tstate.log_odds) == _counts(jstate.log_odds)


def test_map_without_matching_gates_every_robot():
    starts = np.asarray([[0.5, 0.0, 0.0], [-0.5, 0.3, 1.0]], np.float32)
    ranges = simulate_trajectory(World.room(size=10.0), starts,
                                 ht.LaserModel())
    js, ts = _scans(ranges)
    jstate, jm = shared_fleet_step_jit(
        init_shared_fleet(JCFG, 2, start_poses=starts), js, JCFG,
        map_without_matching=True)
    state = ht.init_shared_fleet(TCFG, 2, start_poses=starts, device="cpu")
    for _ in range(2):
        state, m = ht.shared_fleet_step(state, ts, TCFG,
                                        map_without_matching=True)
        assert m.map_updated.all()
        assert torch.equal(state.pose, torch.from_numpy(starts))
    assert int(state.map_update_count) == 2
    one = ht.shared_fleet_step(ht.init_shared_fleet(
        TCFG, 2, start_poses=starts, device="cpu"), ts, TCFG,
        map_without_matching=True)[0]
    for a, b in zip(one.log_odds, jstate.log_odds):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="start_poses"):
        ht.init_shared_fleet(TCFG, 3, start_poses=starts, device="cpu")


def _replay(ref, cfg):
    """The port's shared_fleet_step over a reference's stored ranges:
    (poses f32[T, R, 3], gates bool[T, R], final state)."""
    r = int(ref["robots"])
    state = ht.init_shared_fleet(cfg, r, start_poses=ref["start_poses"],
                                 device="cpu")
    poses, gates = [], []
    for t in range(int(ref["steps"])):
        state, m = ht.shared_fleet_step(
            state, _scans(ref["ranges"][t], cfg)[1], cfg)
        poses.append(state.pose.numpy())
        gates.append(m.map_updated.numpy())
    return np.asarray(poses), np.asarray(gates), state


def test_fresh_small_reference_agrees():
    """The tool's scenario at R = 4, T = 3 on a 256^2 map, written by JAX
    now and replayed through the port as chip_smoke.py replays the
    committed one."""
    ref = mfr.shared_fleet_reference(JCFG, num_robots=4, steps=3, seed=3)
    poses, gates, state = _replay(ref, TCFG)
    np.testing.assert_array_equal(gates, ref["map_updated"])
    assert gates[0].all()
    assert int(state.map_update_count) == int(ref["map_update_count"])
    assert _rmse(poses, ref["poses"]) < RMSE_BUDGET_M
    occ, free = _counts(state.log_odds)
    assert occ == ref["occupied_cells"].tolist()
    assert free == ref["free_cells"].tolist()


def test_committed_reference_is_the_tools_default():
    """The committed file is what the tool's defaults write: its R, T,
    seed and configuration, and its inputs (start poses, ranges) equal a
    fresh run of the scenario (numpy only; the 64-robot JAX replay itself
    runs in the tool, not here)."""
    assert os.path.exists(mfr.REFERENCE)
    with np.load(mfr.REFERENCE) as ref:
        r, steps = int(ref["robots"]), int(ref["steps"])
        assert (r, steps, int(ref["seed"])) == (
            mfr.DEFAULT_ROBOTS, mfr.DEFAULT_STEPS, mfr.DEFAULT_SEED)
        assert str(ref["config"]) == mfr.CONFIG_NAME == "BENCH_CONFIG"
        starts, _, ranges = mfr.scenario(r, steps, mfr.DEFAULT_SEED)
        np.testing.assert_array_equal(ref["start_poses"], starts)
        np.testing.assert_array_equal(ref["ranges"], ranges)
        assert ref["poses"].shape == (steps, r, 3)
        assert ref["map_updated"].shape == (steps, r)
        assert ref["map_updated"][0].all()
        assert 0 < ref["map_updated"][1:].sum()
        assert int(ref["map_update_count"]) == int(
            ref["map_updated"].any(1).sum())
        levels = hs.BENCH_CONFIG.map.levels
        assert ref["occupied_cells"].shape == ref["free_cells"].shape == (
            levels,)
        assert (ref["occupied_cells"] > 0).all()
        assert (ref["truncated_free_cells"] == 0).all()
