"""The fleets' and the batched matchers' compiled entry points on the CPU,
where they run the bodies that the card captures as CUDA graphs
(core/graphs.py):

  - the fleets' select at R = 4 on a 128^2 x 2 map, over steps where
    every robot, some robots and no robot gated: ``fleet_step`` leaves
    each ungated robot's levels and quads bit for bit and equals each
    robot's solo ``slam_step``; ``shared_fleet_step`` leaves the shared
    pyramid, its quads and its update count as they were on a step where
    no robot gated, and gates every robot with ``map_without_matching``;
  - the shared fleet's body held to the JAX bars of
    tests/test_torch_shared_fleet.py: a fresh small JAX reference (gates,
    update count, pose RMSE < 1e-4 m, each level's cell counts) and the
    first steps of the committed 64-robot reference
    (tests/fixtures/shared_fleet_jax_reference.npz: gates, RMSE);
  - ``match_hypotheses_jit`` and ``match_hypotheses_kernel_jit`` (the
    moments kernel's route: its plain version here) bit-equal to the
    eager matchers;
  - every body free of host reads (the guard of tests/test_torch_graphs.py).
"""

import numpy as np
import pytest
import torch

import hector_slam_tpu as hs

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import graphs
from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                simulate_trajectory)
from tests.test_torch_graphs import no_host_reads
from tools import make_torch_fleet_reference as mfr

MAP_KW = dict(resolution=0.05, size_x=128, size_y=128, levels=2)
TCFG = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_ray_cells=128)
# the same map with rays cut at 40 cells: every gated update truncates
TRUNCATING = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_ray_cells=40)
ROBOTS, STEPS = 4, 6
ADVANCE = (0.0, 0.05, 0.1, 0.15)     # m per step: gates at step 0, then
RMSE_BUDGET_M = 1e-4                 # robot 3 at step 3, robot 2 at step 4
REF_STEPS = 2                        # committed reference steps replayed


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fleet_scans():
    """Per step, the robots' scans in a 5 m room, each robot on its own
    straight track (start poses f32[R, 3] in the room's frame)."""
    world = World.room(size=5.0)
    tracks = []
    for r, adv in enumerate(ADVANCE):
        poses = corridor_trajectory(STEPS, advance=adv, weave=0.0)
        poses[:, 0] += -1.0 + 0.4 * r
        poses[:, 1] += -0.6 + 0.4 * r
        tracks.append(poses)
    tracks = np.stack(tracks, 1)                       # [T, R, 3]
    ranges = [simulate_trajectory(world, tracks[:, r], ht.LaserModel(),
                                  range_noise_std=0.005, seed=r)
              for r in range(ROBOTS)]
    scale = TCFG.map.level_scale(0)
    scans = [ht.stack_scans([ht.scan_from_ranges(
        ranges[r][t], scale, ht.LaserModel(), TCFG.max_beams, device="cpu")
        for r in range(ROBOTS)]) for t in range(STEPS)]
    return scans, tracks[0].astype(np.float32)


def test_fleet_step_leaves_ungated_robots_maps_bit_for_bit(fleet_scans):
    """Each ungated robot's levels and quads are left as they were, bit
    for bit, on steps where some robots gate and on steps where none
    does, and every robot equals its solo ``slam_step`` (pose, gate,
    levels, quads): the update's select by robot."""
    scans, _ = fleet_scans
    fleet = ht.init_fleet(TCFG, ROBOTS, device="cpu")
    solo = [ht.init_state(TCFG, device="cpu") for _ in range(ROBOTS)]
    gates = []
    for sc in scans:
        before = graphs.fresh(fleet)
        fleet, m = ht.fleet_step(fleet, sc, TCFG)
        maps = fleet.log_odds + fleet.quads
        kept = before.log_odds + before.quads
        for r in range(ROBOTS):
            solo[r], sm = ht.slam_step(solo[r], ht.Scan(
                sc.points[r], sc.origo[r], sc.mask[r]), TCFG)
            assert torch.equal(sm.map_updated, m.map_updated[r])
            assert torch.equal(fleet.pose[r], solo[r].pose)
            for a, b in zip(maps, solo[r].log_odds + solo[r].quads):
                assert torch.equal(a[r], b)
            if not m.map_updated[r]:
                assert all(torch.equal(a[r], b[r])
                           for a, b in zip(maps, kept))
        gates.append(m.map_updated.numpy())
    gates = np.asarray(gates)
    assert gates[0].all() and not gates[1].any()
    assert 0 < gates[3:].sum() < gates[3:].size   # some robots, not all


@pytest.mark.parametrize("known", [False, True])
def test_shared_fleet_step_updates_only_when_a_robot_gates(fleet_scans,
                                                           known):
    """A step where no robot gates leaves the shared pyramid, its quads
    and the update count as they were, bit for bit, and counts no
    truncated cell; a step where one does updates them once and counts
    its truncated cells (rays cut at 40 cells). With known poses
    (``map_without_matching``) every robot gates on every step."""
    scans, starts = fleet_scans
    state = ht.init_shared_fleet(TRUNCATING, ROBOTS, start_poses=starts,
                                 device="cpu")
    gates, truncated = [], []
    for sc in scans:
        before = graphs.fresh(state)
        state, m = ht.shared_fleet_step(state, sc, TRUNCATING, known)
        kept = all(torch.equal(a, b) for a, b in zip(
            state.log_odds + state.quads, before.log_odds + before.quads))
        gated = bool(m.map_updated.any())
        assert kept != gated
        assert int(state.map_update_count) == int(
            before.map_update_count) + gated
        truncated.append(int(m.truncated_free_cells))
        gates.append(m.map_updated.numpy())
    gates, truncated = np.asarray(gates), np.asarray(truncated)
    assert ((truncated > 0) == gates.any(1)).all()
    if known:
        assert gates.all()
    else:
        assert gates[0].all() and not gates[1].any()
        assert 0 < gates[3:].sum() < gates[3:].size


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a)[..., :2]
                                  - np.asarray(b)[..., :2]) ** 2)))


def _replay_reference(ref, cfg, steps):
    r = int(ref["robots"])
    state = ht.init_shared_fleet(cfg, r, start_poses=ref["start_poses"],
                                 device="cpu")
    scale = cfg.map.level_scale(0)
    poses, gates = [], []
    for t in range(steps):
        scans = ht.stack_scans([ht.scan_from_ranges(
            rg, scale, ht.LaserModel(), cfg.max_beams, device="cpu")
            for rg in ref["ranges"][t]])
        state, m = ht.shared_fleet_step_jit(state, scans, cfg)
        poses.append(state.pose.numpy())
        gates.append(m.map_updated.numpy())
    return np.asarray(poses), np.asarray(gates), state


def test_shared_fleet_body_holds_to_a_fresh_jax_reference():
    kw = dict(resolution=0.05, size_x=256, size_y=256, levels=2)
    jcfg = hs.SlamConfig(map=hs.MapConfig(**kw), max_ray_cells=256)
    tcfg = ht.SlamConfig(map=ht.MapConfig(**kw), max_ray_cells=256)
    ref = mfr.shared_fleet_reference(jcfg, num_robots=4, steps=3, seed=3)
    poses, gates, state = _replay_reference(ref, tcfg, 3)
    np.testing.assert_array_equal(gates, ref["map_updated"])
    assert int(state.map_update_count) == int(ref["map_update_count"])
    assert _rmse(poses, ref["poses"]) < RMSE_BUDGET_M
    assert [int((lo > 0).sum()) for lo in state.log_odds] == \
        ref["occupied_cells"].tolist()
    assert [int((lo < 0).sum()) for lo in state.log_odds] == \
        ref["free_cells"].tolist()


def test_shared_fleet_body_holds_to_the_committed_reference():
    """The first REF_STEPS steps of the 64-robot BENCH_CONFIG reference
    that chip_smoke.py replays on the card (its last-step cell counts are
    held there)."""
    with np.load(mfr.REFERENCE) as ref:
        ref = dict(ref)
    poses, gates, state = _replay_reference(ref, ht.BENCH_CONFIG, REF_STEPS)
    np.testing.assert_array_equal(gates, ref["map_updated"][:REF_STEPS])
    assert _rmse(poses, ref["poses"][:REF_STEPS]) < RMSE_BUDGET_M
    assert int(state.map_update_count) == int(
        ref["map_updated"][:REF_STEPS].any(1).sum())


@pytest.fixture(scope="module")
def mapped(fleet_scans):
    """Robot 2's map after the fleet's first steps, and hypotheses about
    its pose."""
    scans, _ = fleet_scans
    fleet = ht.init_fleet(TCFG, ROBOTS, device="cpu")
    for sc in scans[:3]:
        fleet, _ = ht.fleet_step(fleet, sc, TCFG)
    levels = tuple(lo[2].contiguous() for lo in fleet.log_odds)
    quads = tuple(q[2].contiguous() for q in fleet.quads)
    rng = np.random.default_rng(7)
    hyps = torch.from_numpy((fleet.pose[2].numpy()
                             + rng.normal(0, 0.05, (64, 3)))
                            .astype(np.float32))
    scan = ht.Scan(scans[3].points[2], scans[3].origo[2], scans[3].mask[2])
    return levels, quads, hyps, scan


def test_match_hypotheses_jit_bodies_are_bit_equal(mapped):
    levels, quads, hyps, scan = mapped
    got = ht.match_hypotheses_jit(levels, hyps, scan, TCFG)
    want = ht.match_hypotheses(levels, hyps, scan, TCFG)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for kw in (dict(), dict(quads=quads),
               dict(quads=quads, max_level=1, min_level=1)):
        (res, diag) = ht.match_hypotheses_kernel_jit(levels, hyps, scan,
                                                     TCFG, **kw)
        (wres, wdiag) = ht.match_hypotheses_kernel(levels, hyps, scan,
                                                   TCFG, **kw)
        for a, b in zip(res + diag, wres + wdiag):
            assert torch.equal(a, b)
    assert float(torch.abs(res.pose - hyps).max()) > 0


def test_fleet_bodies_make_no_host_round_trip(fleet_scans, mapped):
    scans, starts = fleet_scans
    levels, quads, hyps, scan = mapped
    fleet = ht.init_fleet(TCFG, ROBOTS, device="cpu")
    shared = ht.init_shared_fleet(TCFG, ROBOTS, start_poses=starts,
                                  device="cpu")

    def bodies():
        yield ht.fleet_step(fleet, scans[0], TCFG)
        yield ht.shared_fleet_step(shared, scans[0], TCFG)
        yield ht.shared_fleet_step(shared, scans[0], TCFG, True)
        yield ht.match_hypotheses_jit(levels, hyps, scan, TCFG)
        yield ht.match_hypotheses_kernel_jit(levels, hyps, scan, TCFG,
                                             quads=quads)

    warm = list(bodies())
    with no_host_reads():
        again = list(bodies())
    assert len(again) == len(warm) == 5
    # the control: a caller that reads the fleet's gates on the host
    with pytest.raises(AssertionError, match="host round trip"):
        with no_host_reads():
            bool(ht.fleet_step(fleet, scans[0], TCFG)[1].map_updated.any())
