"""The compiled sharded steps (hector_slam_tpu_torch/parallel/sharded.py)
on gloo ranks on the CPU:

  - gloo ranks on 2 and 4 ranks (``fleet_step(beam_axis=...)`` and
    ``shared_fleet_step(robot_axis=...)``, the bodies that the card
    captures with their NCCL all-reduces): every rank issues the same
    all-reduces on a step where its group's gate fired and on one where
    none did, and the ranks end bit-equal to the unsharded steps;
  - the compiled route itself (``make_fleet_step``,
    ``make_shared_fleet_step``, ``shard_hypotheses``) rehearsed on four
    ranks: the graph path of core/graphs.py with the capture stand-in of
    tests/test_torch_graphs_replay.py and the group's backend taken as
    one whose collectives a graph holds: one capture a rank, then
    replays, bit-equal to the eager steps;
  - a gloo group runs the body eagerly, even for blocks on the card;
  - the bodies with a group make no host round trip;
  - tests/test_parallel.py::test_sharded_fleet_step_matches_vmap and
    ::test_shared_map_fleet_sharded_matches_single_device mirrored
    against the bodies, with JAX's bars (tests/test_torch_sharded.py).

The ranks import this module to run ``rehearsed_jobs``, so it imports no
JAX at its top: the tests that compare with JAX import it inside. Each
run of ranks has a deadline, so a hung collective fails its test.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import collectives, graphs
from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                simulate_trajectory)
from hector_slam_tpu_torch.parallel import shared_map, sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)   # the ranks import tools/ by name
from tools.torch_sharded_ranks import (fleet_job, hypotheses_job,  # noqa
                                       run_jobs, shared_fleet_job, turn)

DEADLINE_S = 120.0
MAP_KW = dict(resolution=0.05, size_x=128, size_y=128, levels=2)
TCFG = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_ray_cells=128)
ROBOTS, STEPS = 4, 6
ADVANCE = (0.0, 0.05, 0.1, 0.15)   # m per step: every robot gates at step
#   0, robot 3 at step 3, robot 2 at step 4, none at steps 1, 2 and 5
FIELDS = ("poses", "gates", "truncated", "num_valid", "count")
POSE_M = 2e-4   # the beam axis's pose bar (tests/test_parallel.py:123-131)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs():
    """The fleets' inputs: per step, each robot's scan in a 5 m room on
    its own straight track (tests/test_torch_graphs_fleets.py's
    scenario), and the start poses f32[R, 3]."""
    world = World.room(size=5.0)
    tracks = []
    for r, adv in enumerate(ADVANCE):
        poses = corridor_trajectory(STEPS, advance=adv, weave=0.0)
        poses[:, 0] += -1.0 + 0.4 * r
        poses[:, 1] += -0.6 + 0.4 * r
        tracks.append(poses)
    tracks = np.stack(tracks, 1)
    ranges = [simulate_trajectory(world, tracks[:, r], ht.LaserModel(),
                                  range_noise_std=0.005, seed=r)
              for r in range(ROBOTS)]
    scale = TCFG.map.level_scale(0)
    scans = [ht.stack_scans([ht.scan_from_ranges(
        ranges[r][t], scale, ht.LaserModel(), TCFG.max_beams, device="cpu")
        for r in range(ROBOTS)]) for t in range(STEPS)]
    inputs = {f: np.stack([getattr(sc, f).numpy() for sc in scans])
              for f in ht.Scan._fields}
    return inputs, dict(inputs, start_poses=tracks[0].astype(np.float32))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _run(jobs, ranks, fn=run_jobs):
    sharded.run_ranks(fn, ranks, "gloo", (jobs,), deadline_s=DEADLINE_S)
    return [_load(args[4]) for _, args in jobs]


def _equal_turns(got, i, j, levels=TCFG.map.levels):
    a, b = turn(got, i), turn(got, j)
    for k in FIELDS + tuple(f"lo_{k}" for k in range(levels)):
        if k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def rehearsed_jobs(rank, world_size, jobs):
    """``run_jobs`` with the compiled route driven on the CPU: the card
    path of core/graphs.py for CPU tensors with the capture stand-in of
    tests/test_torch_graphs_replay.py, and the group's collectives taken
    as capturable, as an NCCL group's are."""
    from test_torch_graphs_replay import capture_on_cpu
    graphs.on_card = lambda t: True
    graphs._capture = capture_on_cpu
    sharded.captures_collectives = lambda group: True
    shared_map.captures_collectives = lambda group: True
    run_jobs(rank, world_size, jobs)


FOUR_RANK_ROUTES = ("eager", "step", "step")


def _hypotheses_inputs(fleet_in):
    state = ht.init_state(TCFG, device="cpu")
    scan = ht.scan_from_numpy(fleet_in["points"][0, 0],
                              fleet_in["origo"][0, 0],
                              fleet_in["mask"][0, 0], device="cpu")
    state, _ = ht.slam_step(state, scan, TCFG)
    return dict(levels=[lo.numpy() for lo in state.log_odds],
                hypotheses=(np.random.default_rng(0).normal(
                    0, 0.05, (16, 3))).astype(np.float32),
                points=fleet_in["points"][1, 0],
                origo=fleet_in["origo"][1, 0], mask=fleet_in["mask"][1, 0])


def _mirrored_inputs():
    """The runs of tests/test_torch_sharded.py's fleet test (8 robots
    seeded with their own scans, the full laser) and
    tests/test_torch_sharded_fleets.py's shared fleet test (8 robots on a
    ring, 3 steps), and what the tests compare them with."""
    import jax
    import jax.numpy as jnp

    import hector_slam_tpu as hs
    from hector_slam_tpu.io.scanlog import LaserModel as JLaser
    from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
    from hector_slam_tpu.io.scanlog import stack_scans as j_stack
    from hector_slam_tpu.parallel.batch import init_fleet as j_init_fleet
    from test_torch_sharded import (FULL_JCFG, FULL_TCFG, JCFG, JL, _room,
                                    _scan_arrays)
    from test_torch_sharded import TCFG as SCFG
    from test_torch_sharded_fleets import _ring

    r = 8
    scans, poses = _room(ht.LaserModel(), JLaser(), FULL_JCFG, n=r + 1)
    seeded, _ = jax.jit(jax.vmap(
        lambda st, sc, h: hs.slam_step(st, sc, FULL_JCFG, pose_hint=h,
                                       map_without_matching=True)))(
        j_init_fleet(FULL_JCFG, r), j_stack(scans[:r]),
        jnp.asarray(poses[:r]))
    scs2 = j_stack(scans[1:])
    seeded_np = ([np.asarray(lo) for lo in seeded.log_odds],
                 np.asarray(seeded.pose),
                 np.asarray(seeded.last_map_update_pose),
                 np.asarray(seeded.covariance), np.asarray(seeded.step),
                 np.asarray(seeded.map_update_count))
    fleet_in = dict(_scan_arrays(scs2), state=seeded_np)
    starts, _ = _ring(r, 0)
    ring = [j_stack([j_scan(rg, JCFG.map.level_scale(0), JL, JCFG.max_beams)
                     for rg in _ring(r, t)[1]]) for t in range(3)]
    shared_in = {f: np.stack([np.asarray(getattr(sc, f)) for sc in ring])
                 for f in ("points", "origo", "mask")}
    shared_in["start_poses"] = starts
    return (dict(fleet=(fleet_in, seeded, scs2, FULL_JCFG, FULL_TCFG),
                 shared=(shared_in, ring, JCFG, SCFG)))


@pytest.fixture(scope="module")
def four_ranks(inputs, tmp_path_factory):
    """One start of four gloo ranks with the compiled route rehearsed
    (``rehearsed_jobs``): the fleets of ``inputs`` on a (robot 2, beam 2)
    mesh in the turns FOUR_RANK_ROUTES, ``shard_hypotheses`` and the
    eager matcher on 16 hypotheses, and the two mirrored runs through
    the bodies run eagerly."""
    fleet_in, shared_in = inputs
    mirrored = _mirrored_inputs()
    tmp = tmp_path_factory.mktemp("four_ranks")
    fleet, shared, hyp, mfleet, mshared = _run([
        (fleet_job, (TCFG, "cpu", 2, fleet_in, str(tmp / "f.npz"),
                     FOUR_RANK_ROUTES)),
        (shared_fleet_job, (TCFG, "cpu", 2, shared_in, str(tmp / "s.npz"),
                            FOUR_RANK_ROUTES)),
        (hypotheses_job, (TCFG, "cpu", None, _hypotheses_inputs(fleet_in),
                          str(tmp / "h.npz"), ("step", "eager"))),
        (fleet_job, (mirrored["fleet"][-1], "cpu", 2, mirrored["fleet"][0],
                     str(tmp / "mf.npz"), ("eager",))),
        (shared_fleet_job, (mirrored["shared"][-1], "cpu", 2,
                            mirrored["shared"][0], str(tmp / "ms.npz"),
                            ("eager",)))], 4, rehearsed_jobs)
    return dict(fleet=fleet, shared=shared, hypotheses=hyp,
                mirrored_fleet=(mfleet, *mirrored["fleet"]),
                mirrored_shared=(mshared, *mirrored["shared"]))


def _unsharded(inputs):
    """The fleets of ``inputs`` through the unsharded steps here, as the
    jobs write them."""
    fleet_in, shared_in = inputs
    scans, fleet, shared = _start(inputs)
    out = {}
    for name, step, state in (
            ("fleet", lambda st, sc: ht.fleet_step(st, sc, TCFG), fleet),
            ("shared", lambda st, sc: ht.shared_fleet_step(st, sc, TCFG),
             shared)):
        metrics = []
        for sc in scans:
            state, m = step(state, sc)
            metrics.append(m)
        out[name] = dict(
            gates=torch.stack([m.map_updated for m in metrics]).numpy(),
            truncated=torch.stack([m.truncated_free_cells
                                   for m in metrics]).numpy(),
            num_valid=torch.stack([m.num_valid_beams
                                   for m in metrics]).numpy(),
            poses=state.pose.numpy(), count=state.map_update_count.numpy(),
            **{f"lo_{k}": lo.numpy() for k, lo in enumerate(state.log_odds)})
    return out


@pytest.mark.parametrize("ranks,robot_axis", [(2, 1), (4, 2)])
def test_gloo_ranks_issue_the_same_collectives_gated_or_not(
        inputs, tmp_path, request, ranks, robot_axis):
    """Per-robot fleet on a (robot_axis, ranks / robot_axis) mesh, shared
    fleet over every rank, gloo groups: each rank issues as many
    all-reduces on a step where its group's gate fired as on a step where
    none did, the same number as every other rank, and the ranks end
    bit-equal to the unsharded steps: gates, counts and maps, and the
    shared fleet's poses; the beam shards sum the normal equations in
    another order, so the per-robot fleet's poses are held to JAX's bar
    for the beam axis (tests/test_parallel.py:123-131)."""
    fleet_in, shared_in = inputs
    if ranks == 4:
        runs = request.getfixturevalue("four_ranks")
        fleet, shared = runs["fleet"], runs["shared"]
    else:
        fleet, shared = _run([
            (fleet_job, (TCFG, "cpu", robot_axis, fleet_in,
                         str(tmp_path / "fleet.npz"), ("eager",))),
            (shared_fleet_job, (TCFG, "cpu", robot_axis, shared_in,
                                str(tmp_path / "shared.npz"),
                                ("eager",)))], ranks)
    want = _unsharded(inputs)
    for got, ref in ((fleet, want["fleet"]), (shared, want["shared"])):
        assert got["routes"][0] == "eager"
        calls = turn(got, 0)["all_reduces"]
        np.testing.assert_array_equal(calls, turn(got, 0)["all_reduces_min"])
        assert len(set(calls.tolist())) == 1 and calls[0] > 0
        for k in ("gates", "truncated", "num_valid", "count") + tuple(
                f"lo_{k}" for k in range(TCFG.map.levels)):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_allclose(got["poses"][-1], ref["poses"], rtol=0,
                                   atol=POSE_M if got is fleet else 0)
    # steps where a group's gate fired and steps where none did: a row of
    # the per-robot mesh, every rank of the shared fleet
    rows = fleet["gates"].reshape(STEPS, robot_axis, -1).any(-1)
    assert rows[0].all() and not rows[1:3].any() and rows[3:5].any()
    np.testing.assert_array_equal(shared["gates"].any(1),
                                  [1, 0, 0, 1, 1, 0])
    assert 2 < int(shared["count"]) < STEPS


def test_compiled_route_rehearsed_on_four_ranks(four_ranks):
    """The compiled sharded steps as the card runs them, on four gloo
    ranks: one graph captured per rank in the first compiled turn (the
    group in its key), replayed in the next with no capture, the donated
    blocks refilled in place, every turn bit-equal to the eager sharded
    step; ``shard_hypotheses`` through ``match_hypotheses_jit``."""
    for got in (four_ranks["fleet"], four_ranks["shared"]):
        assert list(got["routes"]) == list(FOUR_RANK_ROUTES)
        _equal_turns(got, 1, 0)
        _equal_turns(got, 2, 0)
        assert [int(turn(got, i)["captures"])
                for i in range(3)] == [0, 4, 0]
        assert int(got["t2_pool_bytes"]) == 0   # the stand-in has no pool
    hyp = four_ranks["hypotheses"]
    assert int(hyp["captures"]) == 4 and int(hyp["later_captures"]) == 0
    assert int(hyp["t1_captures"]) == 0
    np.testing.assert_array_equal(hyp["poses"], hyp["t1_poses"])
    np.testing.assert_array_equal(hyp["hessians"], hyp["t1_hessians"])


@pytest.fixture
def one_rank():
    """A one-rank gloo default group in this process, and its mesh."""
    store = dist.TCPStore("localhost", 0, 1, is_master=True)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield sharded.make_mesh()
    finally:
        dist.destroy_process_group()


def _start(inputs):
    fleet_in, shared_in = inputs
    scans = [ht.scan_from_numpy(fleet_in["points"][t], fleet_in["origo"][t],
                                fleet_in["mask"][t], device="cpu")
             for t in range(STEPS)]
    return (scans, ht.init_fleet(TCFG, ROBOTS, device="cpu"),
            ht.init_shared_fleet(TCFG, ROBOTS,
                                 start_poses=shared_in["start_poses"],
                                 device="cpu"))


def test_gloo_group_keeps_the_eager_route(inputs, one_rank, monkeypatch):
    """The route is the group's backend's: with blocks taken for the
    card's, a gloo group still runs the steps eagerly (no graph is
    entered); the same steps on a group taken as NCCL enter the graph
    path, and both are bit-equal to the unsharded steps. A capture that
    fails there raises: the step does not fall back to the eager one."""
    mesh = one_rank
    assert dist.get_backend(mesh.group) == "gloo"
    assert not collectives.captures_collectives(mesh.group)
    scans, _, _ = _start(inputs)
    entered = []
    from test_torch_graphs_replay import capture_on_cpu

    def capture(*args):
        entered.append(args[0])
        return capture_on_cpu(*args)

    monkeypatch.setattr(graphs, "on_card", lambda t: True)
    monkeypatch.setattr(graphs, "_capture", capture)
    graphs.clear()
    states = {}
    for name, captured in (("gloo", False), ("nccl", True)):
        if captured:
            monkeypatch.setattr(sharded, "captures_collectives",
                                lambda group: True)
            monkeypatch.setattr(shared_map, "captures_collectives",
                                lambda group: True)
        step = sharded.make_fleet_step(mesh, TCFG)
        sstep = sharded.make_shared_fleet_step(mesh, TCFG)
        _, f, s = _start(inputs)   # a compiled step donates its blocks
        for sc in scans:
            f, mf = step(f, sc)
            s, ms = sstep(s, sc)
        states[name] = (graphs.fresh(f), graphs.fresh(s), mf, ms)
        assert entered == ([] if not captured else
                           ["sharded_fleet_step", "shared_fleet_step_jit"])
    graphs.clear()
    _, e, es = _start(inputs)
    for sc in scans:
        e, me = ht.fleet_step(e, sc, TCFG)
        es, mes = ht.shared_fleet_step(es, sc, TCFG)
    for f, s, mf, ms in states.values():
        for a, b in zip(list(e.log_odds) + [e.pose, e.map_update_count],
                        list(f.log_odds) + [f.pose, f.map_update_count]):
            assert torch.equal(a, b)
        for a, b in zip(list(es.log_odds) + [es.pose, es.map_update_count],
                        list(s.log_odds) + [s.pose, s.map_update_count]):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(me, mf))
        assert all(torch.equal(a, b) for a, b in zip(mes, ms))

    # a failed capture on the compiled route raises; no eager fallback
    def broken(name, *args):
        raise RuntimeError(f"{name}: CUDA graph capture failed")

    monkeypatch.setattr(graphs, "_capture", broken)
    graphs.clear()
    _, f, s = _start(inputs)
    for step, state in ((sharded.make_fleet_step(mesh, TCFG), f),
                        (sharded.make_shared_fleet_step(mesh, TCFG), s)):
        with pytest.raises(RuntimeError, match="capture failed"):
            step(state, scans[0])
    assert graphs.stats() == []


def test_sharded_bodies_make_no_host_round_trip(inputs, one_rank):
    """The bodies given a group read nothing on the host and copy no host
    value to the device (the guard of tests/test_torch_graphs.py, as
    test_recovery_bodies_make_no_host_round_trip uses it, and no op that
    reads the card in C++, tests/test_torch_queries_compiled.py): their
    collectives included, they can run inside a CUDA graph. (The
    item-assignment guard of that test does not apply: on the CPU the
    paint's plain version stores a Python True where the card launches
    its kernel.)"""
    from test_torch_graphs import no_host_reads
    from test_torch_queries_compiled import no_syncing_ops
    mesh = one_rank
    scans, fleet, shared = _start(inputs)
    fleet, _ = ht.fleet_step(fleet, scans[0], TCFG, beam_axis=mesh.beam_group)
    shared, _ = ht.shared_fleet_step(shared, scans[0], TCFG,
                                     robot_axis=mesh.group)

    def bodies():
        yield ht.fleet_step(fleet, scans[1], TCFG, beam_axis=mesh.beam_group)
        yield ht.shared_fleet_step(shared, scans[1], TCFG,
                                   robot_axis=mesh.group)

    warm = list(bodies())
    with no_host_reads(), no_syncing_ops():
        again = list(bodies())
    for (s1, m1), (s2, m2) in zip(warm, again):
        assert all(torch.equal(a, b) for a, b in zip(
            s1.log_odds + (s1.pose, s1.map_update_count),
            s2.log_odds + (s2.pose, s2.map_update_count)))
        assert all(torch.equal(a, b) for a, b in zip(m1, m2))
    # the control: a caller that reads the steps' gates on the host
    for step in (lambda: ht.fleet_step(fleet, scans[1], TCFG,
                                       beam_axis=mesh.beam_group),
                 lambda: ht.shared_fleet_step(shared, scans[1], TCFG,
                                              robot_axis=mesh.group)):
        with no_host_reads(), pytest.raises(AssertionError,
                                            match="host round trip"):
            bool(step()[1].map_updated.any())


# ---- tests/test_parallel.py mirrored against the bodies --------------------


def test_sync_free_fleet_body_matches_unsharded_and_jax(four_ranks):
    """tests/test_parallel.py::test_sharded_fleet_step_matches_vmap: the
    beam-sharded body against the port's unsharded compiled step and
    JAX's vmapped step: poses within 2e-4, gates equal, finest maps
    > 99.9% equal."""
    import hector_slam_tpu as hs
    got, fleet_in, seeded, scs2, jcfg, tcfg = four_ranks["mirrored_fleet"]
    fleet = ht.fleet_state_from_numpy(*fleet_in["state"], tcfg,
                                      device="cpu")
    want, want_m = ht.fleet_step_jit(fleet, ht.scan_from_numpy(
        fleet_in["points"][0], fleet_in["origo"][0], fleet_in["mask"][0],
        device="cpu"), tcfg)
    jwant, jwant_m = hs.fleet_step_jit(seeded, scs2, jcfg)
    for pose, gates, lo0 in (
            (want.pose.numpy(), want_m.map_updated.numpy(),
             want.log_odds[0].numpy()),
            (np.asarray(jwant.pose), np.asarray(jwant_m.map_updated),
             np.asarray(jwant.log_odds[0]))):
        np.testing.assert_allclose(got["poses"][0], pose, atol=2e-4)
        np.testing.assert_array_equal(got["gates"][0], gates)
        agree = np.mean(got["lo_0"] == lo0)
        assert agree > 0.999, agree
    np.testing.assert_array_equal(got["num_valid"][0],
                                  want_m.num_valid_beams.numpy())


def test_sync_free_shared_body_matches_single_device_and_jax(four_ranks):
    """tests/test_parallel.py::
    test_shared_map_fleet_sharded_matches_single_device: the robots over
    four ranks, one replicated pyramid: bit-equal to the port's unsharded
    compiled step (the OR commutes); against JAX's single-device step
    gates and update counts equal, poses within 2e-4 and at most 8 cells
    of a level apart."""
    from hector_slam_tpu.parallel.shared_map import (init_shared_fleet,
                                                     shared_fleet_step_jit)
    got, shared_in, ring, jcfg, tcfg = four_ranks["mirrored_shared"]
    r = shared_in["mask"].shape[1]
    state = ht.init_shared_fleet(tcfg, r, start_poses=shared_in["start_poses"],
                                 device="cpu")
    j1 = init_shared_fleet(jcfg, r, start_poses=shared_in["start_poses"])
    poses, gates = [], []
    for t, sc in enumerate(ring):
        state, m = ht.shared_fleet_step_jit(state, ht.scan_from_numpy(
            shared_in["points"][t], shared_in["origo"][t],
            shared_in["mask"][t], device="cpu"), tcfg)
        poses.append(state.pose.numpy())
        gates.append(m.map_updated.numpy())
        j1, jm = shared_fleet_step_jit(j1, sc, jcfg)
    np.testing.assert_array_equal(got["poses"], np.stack(poses))
    np.testing.assert_array_equal(got["gates"], np.stack(gates))
    assert int(got["count"]) == int(state.map_update_count)
    np.testing.assert_array_equal(got["gates"][-1], np.asarray(jm.map_updated))
    assert int(got["count"]) == int(j1.map_update_count)
    np.testing.assert_allclose(got["poses"][-1], np.asarray(j1.pose),
                               atol=2e-4)
    for k in range(tcfg.map.levels):
        np.testing.assert_array_equal(got[f"lo_{k}"],
                                      state.log_odds[k].numpy())
        diff = (got[f"lo_{k}"] != np.asarray(j1.log_odds[k])).sum()
        assert diff <= 8, (k, diff)
