"""The port's sharded steps (hector_slam_tpu_torch/parallel/sharded.py) on
gloo ranks on the CPU, held against the port's unsharded steps and against
the JAX package's sharded steps on the 8-device virtual mesh of
tests/conftest.py. Mirrors tests/test_parallel.py:93-145 and :249-280
(tests/test_torch_sharded_fleets.py mirrors :376-420 and
tests/test_multiprocess.py:32-62). Each run of ranks has a deadline
(``run_ranks`` kills them past it), so a hung collective fails its test.

The port's ranks form a (robot 2, beam 2) mesh, JAX's a (robot 4, beam 2)
mesh: the sharding is an implementation detail, not a change of result.
Bars, JAX's own (tests/test_parallel.py:123-131, 143-144): sharding over
robots only gives poses, gates and maps bit-equal to the unsharded step
(every op is per robot, and the sums run in ``beam_sum``'s fixed order);
with the beam axis, the two halves of a scan are summed apart and then
added, so poses agree within 2e-4, gates exactly, and the finest maps on
more than 99.9% of cells; ``shard_hypotheses`` within 1e-6 of the
unsharded matcher; the port's sharded fleet against JAX's sharded fleet:
gates equal, poses within 2e-4."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hector_slam_tpu as hs
from hector_slam_tpu.io.scanlog import LaserModel as JLaser
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.io.scanlog import stack_scans as j_stack
from hector_slam_tpu.parallel import sharded as jsh
from hector_slam_tpu.parallel.batch import init_fleet as j_init_fleet
from hector_slam_tpu.parallel.batch import match_hypotheses_jit

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                simulate_trajectory)
from hector_slam_tpu_torch.parallel import sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)   # the ranks import tools/ by name
from tools.torch_sharded_ranks import (fleet_job, hypotheses_job,  # noqa
                                       mesh_job)

DEADLINE_S = 120.0
LASER_KW = dict(num_beams=181, angle_min=-1.5707964,
                angle_increment=0.017453293, range_min=0.1, range_max=10.0)
MAP_KW = dict(resolution=0.05, size_x=256, size_y=256, levels=2)
JCFG = hs.SlamConfig(map=hs.MapConfig(**MAP_KW), max_beams=256,
                     max_ray_cells=256)
TCFG = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_beams=256,
                     max_ray_cells=256)
TL = ht.LaserModel(**LASER_KW)
JL = JLaser(**LASER_KW)
# the full 1081-beam UTM-30LX: with the 181-beam laser above, a robot's GN
# iterates can bifurcate on a 1e-6 difference between the packages (one
# robot of the fleet test lands 0.11 m apart, sharded or not), with the
# full laser they agree to ~1e-6 (tests/test_torch_fleet.py)
FULL_JCFG = hs.SlamConfig(map=hs.MapConfig(**MAP_KW), max_beams=1152,
                          max_ray_cells=256)
FULL_TCFG = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_beams=1152,
                          max_ray_cells=256)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(job, ranks, robot_axis, cfg, inputs, path):
    sharded.run_ranks(job, ranks, "gloo",
                      (cfg, "cpu", robot_axis, inputs, str(path)),
                      deadline_s=DEADLINE_S)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _scan_arrays(scan):
    """A JAX scan (leading robot axis) as a job's one-step inputs."""
    return dict(points=np.asarray(scan.points)[None],
                origo=np.asarray(scan.origo)[None],
                mask=np.asarray(scan.mask)[None])


def _torch_scan(arrays, t=0):
    return ht.scan_from_numpy(arrays["points"][t], arrays["origo"][t],
                              arrays["mask"][t], device="cpu")


def _room(laser, jlaser, cfg, n=8):
    """tests/test_parallel.py's fixture: a room, n corridor poses, and the
    JAX scans of them."""
    poses = corridor_trajectory(n, advance=0.05, weave=0.03)
    ranges = simulate_trajectory(World.room(size=10.0), poses, laser)
    scans = [j_scan(r, cfg.map.level_scale(0), jlaser, cfg.max_beams)
             for r in ranges]
    return scans, poses


@pytest.fixture(scope="module")
def room():
    return _room(TL, JL, JCFG)


def test_make_mesh_factorizes_as_jax():
    """The (robot, beam) shape of n ranks is JAX's for n devices; a 1-rank
    group gives the 1 x 1 mesh; make_mesh needs an initialized group."""
    for n in range(1, 9):
        assert sharded.mesh_shape(n) == jsh.make_mesh(n).devices.shape
        assert sharded.mesh_shape(n, n) == jsh.make_mesh(n, n).devices.shape
    with pytest.raises(ValueError):
        sharded.mesh_shape(8, 3)
    with pytest.raises(RuntimeError, match="process group"):
        sharded.make_mesh()
    import torch.distributed as dist
    store = dist.TCPStore("localhost", 0, 1, is_master=True)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = sharded.make_mesh()
        assert (mesh.robot, mesh.beam, mesh.rank, mesh.row, mesh.column,
                mesh.size) == (1, 1, 0, 0, 0, 1)
        with pytest.raises(ValueError):
            sharded.make_mesh(2)   # more ranks than the group has
    finally:
        dist.destroy_process_group()


def test_make_mesh_groups_on_four_ranks(tmp_path):
    """On four ranks: the (robot 2, beam 2) mesh's rows, columns and
    groups (an all-reduce of the ranks over each), and a 2-rank mesh over
    the first two ranks, which the other two are outside of."""
    path = str(tmp_path / "mesh.npz")
    sharded.run_ranks(mesh_job, 4, "gloo", (path,), deadline_s=DEADLINE_S)
    with np.load(path) as z:
        places, shapes = z["places"], z["shapes"]
    np.testing.assert_array_equal(shapes, [2, 2, 1, 2])
    np.testing.assert_array_equal(places, [
        [0, 0, 1, 6, 0, 0, 1, 1],
        [0, 1, 1, 6, 0, 1, 1, 1],
        [1, 0, 5, 6, -1, -1, -1, -1],
        [1, 1, 5, 6, -1, -1, -1, -1]])


def test_sharded_fleet_step_matches_unsharded_and_jax(tmp_path):
    """tests/test_parallel.py:93-131 with the full laser: R = 8 robots,
    robot i's map seeded with scan i at its known pose, then one step on
    scan i + 1, with robots over the rows and beams over the columns (576
    of 1152 a rank). Each robot's map is its own scan's, so every GN run
    converges: a robot seeded at another's pose (as the JAX test seeds
    them all at pose 0) is far from its basin, and its non-converged GN
    iterates are chaotic, here and across packages."""
    JCFG, TCFG = FULL_JCFG, FULL_TCFG
    r = 8
    scans, poses = _room(ht.LaserModel(), JLaser(), JCFG, n=r + 1)
    seeded, _ = jax.jit(jax.vmap(
        lambda st, sc, h: hs.slam_step(st, sc, JCFG, pose_hint=h,
                                       map_without_matching=True)))(
        j_init_fleet(JCFG, r), j_stack(scans[:r]), jnp.asarray(poses[:r]))
    scs2 = j_stack(scans[1:])
    mesh = jsh.make_mesh(8)
    want_jax, want_jax_m = jsh.make_fleet_step(mesh, JCFG)(
        jsh.shard_fleet_state(seeded, mesh, JCFG), jsh.shard_scan(scs2, mesh))

    seeded_np = ([np.asarray(lo) for lo in seeded.log_odds],
                 np.asarray(seeded.pose),
                 np.asarray(seeded.last_map_update_pose),
                 np.asarray(seeded.covariance), np.asarray(seeded.step),
                 np.asarray(seeded.map_update_count))
    inputs = dict(_scan_arrays(scs2), state=seeded_np)
    got = _run(fleet_job, 4, 2, TCFG, inputs, tmp_path / "fleet.npz")
    fleet = ht.fleet_state_from_numpy(*seeded_np, TCFG, device="cpu")
    want, want_m = ht.fleet_step(fleet, _torch_scan(inputs), TCFG)

    np.testing.assert_allclose(got["poses"][0], want.pose.numpy(), atol=2e-4)
    np.testing.assert_array_equal(got["gates"][0], want_m.map_updated.numpy())
    agree = np.mean(got["lo_0"] == want.log_odds[0].numpy())
    assert agree > 0.999, agree
    np.testing.assert_array_equal(got["num_valid"][0],
                                  want_m.num_valid_beams.numpy())
    # against JAX's sharded step on its own mesh
    np.testing.assert_allclose(got["poses"][0], np.asarray(want_jax.pose),
                               atol=2e-4)
    np.testing.assert_array_equal(got["gates"][0],
                                  np.asarray(want_jax_m.map_updated))
    agree = np.mean(got["lo_0"] == np.asarray(want_jax.log_odds[0]))
    assert agree > 0.999, agree


def test_sharded_hypotheses_matches_unsharded(room, tmp_path):
    """tests/test_parallel.py:134-144: 32 hypotheses over 4 ranks."""
    scans, poses = room
    state = hs.init_state(JCFG)
    for sc, p in zip(scans[:4], poses[:4]):
        state, _ = hs.slam_step(state, sc, JCFG, pose_hint=jnp.asarray(p),
                                map_without_matching=True)
    rng = np.random.default_rng(2)
    hyps = (poses[4] + rng.normal(0, 0.05, (32, 3))).astype(np.float32)
    levels = [np.array(lo) for lo in state.log_odds]
    inputs = dict(levels=levels, hypotheses=hyps,
                  points=np.asarray(scans[4].points),
                  origo=np.asarray(scans[4].origo),
                  mask=np.asarray(scans[4].mask))
    got = _run(hypotheses_job, 4, None, TCFG, inputs, tmp_path / "hyp.npz")
    want = ht.match_hypotheses(
        [torch.from_numpy(lo) for lo in levels], torch.from_numpy(hyps),
        ht.scan_from_numpy(inputs["points"], inputs["origo"],
                           inputs["mask"], device="cpu"), TCFG)
    np.testing.assert_allclose(got["poses"], want.pose.numpy(), atol=1e-6)
    np.testing.assert_allclose(got["hessians"], want.hessian.numpy(),
                               rtol=1e-6, atol=1e-6)
    # JAX's sharded matcher: the packages sum in other orders, so hold
    # the bulk as tests/test_torch_fleet.py holds the unsharded matchers
    jax_pose = np.asarray(jsh.shard_hypotheses(jsh.make_mesh(8), JCFG)(
        state.log_odds, jnp.asarray(hyps), scans[4]).pose)
    diff = np.abs(got["poses"] - jax_pose).max(-1)
    assert np.percentile(diff, 90) < 1e-4, diff
    np.testing.assert_allclose(
        jax_pose, np.asarray(match_hypotheses_jit(
            state.log_odds, jnp.asarray(hyps), scans[4], JCFG).pose),
        atol=1e-6)


def test_sharded_fleet_production_beams(tmp_path):
    """tests/test_parallel.py:249-280 at a 512^2 x 2 map: the full
    1081-beam UTM-30LX, one gated step of 4 robots, the beams padded with
    masked ones to a multiple of the beam axis (1081 -> 1082) and split
    over 2 ranks."""
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=512,
                                         size_y=512, levels=2),
                        max_beams=1081, max_ray_cells=640)
    r = 4
    laser = ht.LaserModel()
    ranges = simulate_trajectory(World.corridor(length=18.0, width=3.0),
                                 np.zeros((r, 3), np.float32), laser)
    scans = ht.stack_scans([ht.scan_from_ranges(
        rg, cfg.map.level_scale(0), laser, cfg.max_beams, device="cpu")
        for rg in ranges])
    assert sharded.shard_scan(scans, sharded.Mesh(
        2, 2, 3, None, None)).mask.shape == (2, 541)
    inputs = dict(points=scans.points.numpy()[None],
                  origo=scans.origo.numpy()[None],
                  mask=scans.mask.numpy()[None])
    got = _run(fleet_job, 4, 2, cfg, inputs, tmp_path / "prod.npz")
    assert got["poses"].shape == (1, r, 3)
    assert got["gates"].all(), "first scan must map"
    assert (got["truncated"] == 0).all()
    assert got["num_valid"].min() > 1000
    occ = (got["lo_0"] > 0).sum(axis=(1, 2))
    free = (got["lo_0"] < 0).sum(axis=(1, 2))
    assert (occ > 100).all() and (free > 1000).all()
    want, want_m = ht.fleet_step(ht.init_fleet(cfg, r, device="cpu"), scans,
                                 cfg)
    # the first step has no map to match against: the poses stay, and
    # the cell sets are the same sets, OR-combined
    np.testing.assert_array_equal(got["poses"][0], want.pose.numpy())
    np.testing.assert_array_equal(got["num_valid"][0],
                                  want_m.num_valid_beams.numpy())
    for k in range(2):
        np.testing.assert_array_equal(got[f"lo_{k}"],
                                      want.log_odds[k].numpy())
