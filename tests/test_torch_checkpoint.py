"""The port's checkpoints (hector_slam_tpu_torch/io/checkpoint.py) against
the JAX package's (mirrors tests/test_ecosystem.py:242-276): a round trip
in the port, and a checkpoint written by either package loaded by the
other, bit-equal, for one robot, a fleet with a map per robot and a
shared-map fleet; and the refusals of a checkpoint whose level count or a
leaf's shape differs from the config and template."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hector_slam_tpu.config as jc
from hector_slam_tpu.core.slam import init_state, slam_step_jit
from hector_slam_tpu.io.checkpoint import load_state as j_load
from hector_slam_tpu.io.checkpoint import save_state as j_save
from hector_slam_tpu.io.scanlog import LaserModel as JLaser
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.io.scanlog import stack_scans as j_stack
from hector_slam_tpu.parallel.batch import fleet_step_jit
from hector_slam_tpu.parallel.batch import init_fleet as j_init_fleet
from hector_slam_tpu.parallel.shared_map import init_shared_fleet as j_shared
from hector_slam_tpu.parallel.shared_map import shared_fleet_step_jit

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core.slam import quads_of
from hector_slam_tpu_torch.io.checkpoint import checkpoint_leaves
from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                simulate_trajectory)

MAP_KW = dict(resolution=0.05, size_x=256, size_y=256, levels=2)
JCFG = jc.SlamConfig(map=jc.MapConfig(**MAP_KW), max_beams=384,
                     max_ray_cells=256)
TCFG = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_beams=384,
                     max_ray_cells=256)
LASER = JLaser(num_beams=271, angle_min=-2.356194490192345,
               angle_increment=4 * 0.004363323129985824, range_min=0.1,
               range_max=12.0)
R = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _leaves(state):
    """A port or JAX state's checkpoint leaves as numpy."""
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for x in checkpoint_leaves(state)]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def states():
    """JAX states with maps, poses and counters: one robot mapped from 10
    room scans at known poses, a fleet of R robots and a shared-map fleet
    of R robots after two matched steps each."""
    world = World.room(size=10.0)
    poses = corridor_trajectory(10, advance=0.06, weave=0.03)
    scale = JCFG.map.level_scale(0)
    scans = [j_scan(r, scale, LASER, JCFG.max_beams)
             for r in simulate_trajectory(world, poses, LASER)]
    single = init_state(JCFG)
    for sc, p in zip(scans, poses):
        single, _ = slam_step_jit(single, sc, JCFG, pose_hint=jnp.asarray(p),
                                  map_without_matching=True)
    fleet = j_init_fleet(JCFG, R)
    starts = np.asarray([[0.0, 0.0, 0.0], [1.0, -0.5, 0.7],
                         [-1.0, 0.5, -0.7]], np.float32)
    shared = j_shared(JCFG, R, start_poses=starts)
    for t in range(2):
        fleet, _ = fleet_step_jit(fleet, j_stack(scans[t:t + R]), JCFG)
        ranges = simulate_trajectory(world, starts, LASER, seed=t)
        shared, _ = shared_fleet_step_jit(shared, j_stack(
            [j_scan(r, scale, LASER, JCFG.max_beams) for r in ranges]), JCFG)
    return {"single": single, "fleet": fleet, "shared": shared}


def _templates(kind):
    """The (JAX, port) templates of a layout; None is the default."""
    if kind == "single":
        return None, None
    if kind == "fleet":
        return (j_init_fleet(JCFG, R), ht.init_fleet(TCFG, R, device="cpu"))
    return (j_shared(JCFG, R), ht.init_shared_fleet(TCFG, R, device="cpu"))


def _port_state(jstate, kind):
    levels, pose, last, cov, step, count = (
        [np.asarray(lo) for lo in jstate.log_odds], jstate.pose,
        jstate.last_map_update_pose, jstate.covariance, jstate.step,
        jstate.map_update_count)
    if kind == "single":
        return ht.state_from_numpy(levels, pose, last, cov, step, count, TCFG,
                                   device="cpu")
    return ht.fleet_state_from_numpy(levels, pose, last, cov, step, count,
                                     TCFG, device="cpu")


def test_checkpoint_roundtrip(tmp_path, states):
    """tests/test_ecosystem.py:242-260 in the port: every leaf back bit
    for bit, quads recomputed, a config of another level count refused."""
    state = _port_state(states["single"], "single")
    p = str(tmp_path / "ckpt.npz")
    ht.save_state(p, state)
    restored = ht.load_state(p, TCFG, device="cpu")
    _assert_same(restored, state)
    assert all(t.device.type == "cpu" for t in restored.log_odds)
    for a, b in zip(restored.quads, state.quads):
        assert torch.equal(a, b)
    assert int(restored.step) == int(state.step) == 10
    bad = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=256,
                                         size_y=256, levels=3))
    with pytest.raises(ValueError, match="levels"):
        ht.load_state(p, bad, device="cpu")


def test_checkpoint_shared_fleet_roundtrip(tmp_path):
    """tests/test_ecosystem.py:263-276: a shared fleet through its
    template; the single-robot template refuses the batched leaves."""
    starts = np.asarray([[0.0, 0.0, 0.0], [1.0, -0.5, 0.7]], np.float32)
    state = ht.init_shared_fleet(TCFG, 2, start_poses=starts, device="cpu")
    p = str(tmp_path / "fleet.npz")
    ht.save_state(p, state)
    restored = ht.load_state(p, TCFG, template=ht.init_shared_fleet(
        TCFG, 2, device="cpu"), device="cpu")
    np.testing.assert_array_equal(restored.pose.numpy(), starts)
    assert restored.covariance.shape == (2, 3, 3)
    with pytest.raises(ValueError, match="shape"):
        ht.load_state(p, TCFG, device="cpu")


@pytest.mark.parametrize("kind", ["single", "fleet", "shared"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, states, kind):
    jstate = states[kind]
    p = str(tmp_path / f"{kind}_jax.npz")
    j_save(p, jstate)
    restored = ht.load_state(p, TCFG, template=_templates(kind)[1],
                             device="cpu")
    _assert_same(restored, jstate)
    for a, b in zip(restored.quads, quads_of(restored.log_odds,
                                             TCFG.update.cell_model)):
        assert torch.equal(a, b)
    assert restored.quads[0].shape[-2:] == (256 * 256, 4)


@pytest.mark.parametrize("kind", ["single", "fleet", "shared"])
def test_port_checkpoint_loads_in_jax(tmp_path, states, kind):
    state = _port_state(states[kind], kind)
    p = str(tmp_path / f"{kind}_port.npz")
    ht.save_state(p, state)
    restored = j_load(p, JCFG, template=_templates(kind)[0])
    _assert_same(restored, state)
    _assert_same(restored, states[kind])
    # the two files hold the same arrays under the same names
    q = str(tmp_path / f"{kind}_jax.npz")
    j_save(q, states[kind])
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_refuses_a_leaf_of_another_shape(tmp_path, states):
    """A 3-robot fleet's checkpoint under a 2-robot template, and a
    per-robot fleet's under a shared-fleet template, in both packages."""
    p = str(tmp_path / "fleet.npz")
    ht.save_state(p, _port_state(states["fleet"], "fleet"))
    for template in (ht.init_fleet(TCFG, 2, device="cpu"),
                     ht.init_shared_fleet(TCFG, R, device="cpu")):
        with pytest.raises(ValueError, match="shape"):
            ht.load_state(p, TCFG, template=template, device="cpu")
    with pytest.raises(ValueError):
        j_load(p, JCFG, template=j_init_fleet(JCFG, 2))


def test_dcp_checkpoint_roundtrip_matches_the_orbax_pair(tmp_path, states):
    """The directory checkpoints: the port's ``save_state_dcp`` /
    ``load_state_dcp`` (torch.distributed.checkpoint, one process, no
    process group) give every leaf back bit for bit with its quads
    recomputed, as the JAX package's orbax pair does for the same state;
    the default device is the card."""
    from hector_slam_tpu.io.checkpoint import (load_state_orbax,
                                               save_state_orbax)
    state = _port_state(states["single"], "single")
    p = str(tmp_path / "dcp")
    assert ht.save_state_dcp(p, state)
    restored = ht.load_state_dcp(p, TCFG, device="cpu")
    _assert_same(restored, state)
    for a, b in zip(restored.quads, state.quads):
        assert torch.equal(a, b)
    assert all(t.device.type == "cpu" for t in restored.log_odds)
    assert save_state_orbax(str(tmp_path / "orbax"), states["single"])
    _assert_same(load_state_orbax(str(tmp_path / "orbax"), JCFG), restored)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ht.load_state_dcp(p, TCFG)


def test_dcp_checkpoint_refuses_another_config(tmp_path, states):
    """``load_state_dcp`` refuses a config of another level count or map
    size, as ``load_state`` does."""
    p = str(tmp_path / "dcp")
    assert ht.save_state_dcp(p, _port_state(states["single"], "single"))
    three = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=256,
                                           size_y=256, levels=3))
    with pytest.raises(ValueError, match="levels"):
        ht.load_state_dcp(p, three, device="cpu")
    wide = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=512,
                                          size_y=256, levels=2))
    with pytest.raises(ValueError, match="shape"):
        ht.load_state_dcp(p, wide, device="cpu")
