"""The port's sharded shared-map fleet and the rank launcher on gloo ranks
on the CPU (the per-robot fleet and the hypotheses are in
tests/test_torch_sharded.py, whose helpers and bars this file shares):
mirrors tests/test_parallel.py:376-420 and tests/test_multiprocess.py:
32-62, against the port's unsharded steps and JAX's sharded and unsharded
ones; and run_ranks' refusals, its failing-rank path and its deadline.
Each run of ranks has a deadline, so a hung collective fails its test."""

import numpy as np
import pytest
import torch

import hector_slam_tpu as hs
from hector_slam_tpu.io.scanlog import LaserModel as JLaser
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.io.scanlog import stack_scans as j_stack
from hector_slam_tpu.io.simulator import World as JWorld
from hector_slam_tpu.io.simulator import raycast as j_raycast
from hector_slam_tpu.parallel import sharded as jsh
from hector_slam_tpu.parallel.batch import init_fleet as j_init_fleet
from hector_slam_tpu.parallel.shared_map import (init_shared_fleet,
                                                 shared_fleet_step_jit)

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.io.simulator import World, simulate_trajectory
from hector_slam_tpu_torch.parallel import sharded
from test_torch_sharded import (DEADLINE_S, JCFG, JL, TCFG, TL, _run,
                                _scan_arrays, _torch_scan)
from tools.torch_sharded_ranks import (fleet_job, shared_fleet_job,
                                       stall_job)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ring(r, t, seed_base=0):
    """tests/test_parallel.py:389-410: R robots on a ring in the room,
    each advancing 0.05 m a step along its heading; the ranges of step
    t."""
    ang = np.linspace(0, 2 * np.pi, r, endpoint=False)
    starts = np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang),
                       ang + np.pi / 2], -1).astype(np.float32)
    head = np.stack([np.cos(starts[:, 2]), np.sin(starts[:, 2]),
                     np.zeros(r, np.float32)], -1)
    p = (starts + t * 0.05 * head).astype(np.float32)
    return starts, simulate_trajectory(World.room(size=10.0), p, TL,
                                       range_noise_std=0.002,
                                       seed=seed_base + t)


def test_shared_fleet_sharded_matches_unsharded_and_jax(tmp_path):
    """tests/test_parallel.py:376-420: 8 robots over the whole 4-rank
    mesh, one replicated pyramid, 3 steps. The OR of cell sets commutes
    and every robot's match is its own, so the port's sharded fleet is
    bit-equal to its unsharded one."""
    r, steps = 8, 3
    starts, _ = _ring(r, 0)
    scans = [j_stack([j_scan(rg, JCFG.map.level_scale(0), JL, JCFG.max_beams)
                      for rg in _ring(r, t)[1]]) for t in range(steps)]
    inputs = {f: np.stack([np.asarray(getattr(sc, f)) for sc in scans])
              for f in ("points", "origo", "mask")}
    inputs["start_poses"] = starts
    got = _run(shared_fleet_job, 4, 2, TCFG, inputs, tmp_path / "shared.npz")

    state = ht.init_shared_fleet(TCFG, r, start_poses=starts, device="cpu")
    poses, gates, trunc = [], [], []
    for t in range(steps):
        state, m = ht.shared_fleet_step(state, _torch_scan(inputs, t), TCFG)
        poses.append(state.pose.numpy())
        gates.append(m.map_updated.numpy())
        trunc.append(int(m.truncated_free_cells))
    np.testing.assert_array_equal(got["poses"], np.stack(poses))
    np.testing.assert_array_equal(got["gates"], np.stack(gates))
    np.testing.assert_array_equal(got["truncated"], trunc)
    assert int(got["count"]) == int(state.map_update_count)
    for k in range(TCFG.map.levels):
        np.testing.assert_array_equal(got[f"lo_{k}"],
                                      state.log_odds[k].numpy())

    # JAX's sharded shared fleet on the 8-device mesh
    mesh = jsh.make_mesh()
    step = jsh.make_shared_fleet_step(mesh, JCFG)
    jstate = jsh.shard_shared_fleet_state(
        init_shared_fleet(JCFG, r, start_poses=starts), mesh, JCFG)
    jgates = []
    for sc in scans:
        jstate, jm = step(jstate, jsh.shard_shared_fleet_scan(sc, mesh))
        jgates.append(np.asarray(jm.map_updated))
    np.testing.assert_array_equal(got["gates"], np.stack(jgates))
    np.testing.assert_allclose(got["poses"][-1], np.asarray(jstate.pose),
                               atol=2e-4)
    for k in range(TCFG.map.levels):
        diff = (got[f"lo_{k}"] != np.asarray(jstate.log_odds[k])).sum()
        assert diff <= 8, (k, diff)
    # the unsharded JAX step agrees with both
    j1 = init_shared_fleet(JCFG, r, start_poses=starts)
    for sc in scans:
        j1, _ = shared_fleet_step_jit(j1, sc, JCFG)
    np.testing.assert_allclose(got["poses"][-1], np.asarray(j1.pose),
                               atol=2e-4)


def test_robot_axis_across_processes_is_bit_equal(tmp_path):
    """tests/test_multiprocess.py:32-62 with tools/mp_worker.py's inputs:
    the robot axis spanning two processes gives the same poses, gates and
    maps as one process, bit for bit, and as the unsharded fleet_step."""
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.1, size_x=64,
                                         size_y=64, levels=2),
                        max_beams=128, max_ray_cells=64)
    jcfg = hs.SlamConfig(map=hs.MapConfig(resolution=0.1, size_x=64,
                                          size_y=64, levels=2),
                         max_beams=128, max_ray_cells=64)
    kw = dict(num_beams=91, angle_min=-1.57, angle_increment=0.0349,
              range_min=0.1, range_max=5.0)
    laser = JLaser(**kw)
    world = JWorld.room(size=5.0)
    rng = np.random.default_rng(7)
    r = 8
    scans = j_stack([j_scan(j_raycast(world, np.array(
        [0.0, 0.0, rng.uniform(-0.1, 0.1)]), laser), cfg.map.level_scale(0),
        laser, cfg.max_beams) for _ in range(r)])
    inputs = _scan_arrays(scans)
    two = _run(fleet_job, 2, 2, cfg, inputs, tmp_path / "two.npz")
    one = _run(fleet_job, 1, 1, cfg, inputs, tmp_path / "one.npz")
    want, want_m = ht.fleet_step(ht.init_fleet(cfg, r, device="cpu"),
                                 _torch_scan(inputs), cfg)
    for got in (two, one):
        np.testing.assert_array_equal(got["gates"][0],
                                      want_m.map_updated.numpy())
        np.testing.assert_array_equal(got["poses"][0], want.pose.numpy())
        np.testing.assert_array_equal(got["lo_0"], want.log_odds[0].numpy())
    jfleet, _ = hs.fleet_step_jit(j_init_fleet(jcfg, r), scans, jcfg)
    np.testing.assert_array_equal(two["lo_0"], np.asarray(jfleet.log_odds[0]))


def test_run_ranks_fails_fast_and_kills_hung_ranks(tmp_path):
    """A backend that is not available raises; a rank that fails (8 robots
    do not split over 3 rows) fails the run; a collective that never
    completes is killed at the deadline."""
    with pytest.raises(RuntimeError, match="not available"):
        sharded.run_ranks(stall_job, 1, "no-such-backend")
    inputs = dict(points=np.zeros((1, 8, 4, 2), np.float32),
                  origo=np.zeros((1, 8, 2), np.float32),
                  mask=np.ones((1, 8, 4), bool))
    with pytest.raises(RuntimeError, match="exited with code"):
        sharded.run_ranks(fleet_job, 3, "gloo",
                          (TCFG, "cpu", 3, inputs, str(tmp_path / "x.npz")),
                          deadline_s=DEADLINE_S)
    with pytest.raises(TimeoutError):
        sharded.run_ranks(stall_job, 2, "gloo", (60.0,), deadline_s=5.0)
