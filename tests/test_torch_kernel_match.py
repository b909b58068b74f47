"""The port's batched matcher (parallel/kernel_match.py) against the JAX
Pallas driver on the CPU (mirrors tests/test_pallas_match.py:189-270):
a 256^2, 2-level map built by the JAX engine from a simulated corridor,
carried across with state_from_numpy, and 256 hypotheses matched by both
``match_hypotheses_pallas(interpret=True)`` and ``match_hypotheses_kernel``
(whose moments take the plain version on the CPU). Non-converged GN
iterates amplify f32 summation-order differences, so poses are held to
2e-3 at most, as the JAX test holds the Pallas driver to the quad path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hector_slam_tpu as hs
from hector_slam_tpu.io.scanlog import LaserModel, scan_from_ranges
from hector_slam_tpu.io.simulator import World, simulate_trajectory
from hector_slam_tpu.parallel.pallas_match import match_hypotheses_pallas

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.ops import interp_moments as im
from hector_slam_tpu_torch.parallel.kernel_match import (
    gn_step_kernel, match_hypotheses_kernel)
from test_torch_cuda import _bits_equal

H = W = 256


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(levels=2):
    kw = dict(resolution=0.05, size_x=H, size_y=W, levels=levels)
    return (hs.SlamConfig(map=hs.MapConfig(**kw), max_ray_cells=256),
            ht.SlamConfig(map=ht.MapConfig(**kw), max_ray_cells=256))


@pytest.fixture(scope="module")
def mapped():
    """A JAX-built map, the same state in the port, the last scan in both
    packages and 256 hypotheses around the final pose."""
    jcfg, tcfg = _cfgs()
    state = hs.init_state(jcfg)
    laser = LaserModel(num_beams=181, angle_min=-1.57,
                       angle_increment=np.pi / 180, range_max=8.0)
    poses_true = np.zeros((8, 3), np.float32)
    poses_true[:, 0] = np.linspace(0, 0.4, 8)
    ranges = simulate_trajectory(World.corridor(length=8.0, width=3.0),
                                 poses_true, laser, range_noise_std=0.0)
    scans = [scan_from_ranges(r, 1 / jcfg.map.resolution, laser,
                              jcfg.max_beams) for r in ranges]
    for sc in scans:
        state, _ = hs.slam_step_jit(state, sc, jcfg)
    tstate = ht.state_from_numpy(
        [np.asarray(lo) for lo in state.log_odds], np.asarray(state.pose),
        np.asarray(state.last_map_update_pose),
        np.asarray(state.covariance), int(state.step),
        int(state.map_update_count), tcfg, device="cpu")
    tscan = ht.scan_from_numpy(np.asarray(scans[-1].points),
                               np.asarray(scans[-1].origo),
                               np.asarray(scans[-1].mask), device="cpu")
    rng = np.random.default_rng(7)
    hyp = (np.asarray(state.pose) + np.c_[rng.normal(0, 0.03, (256, 2)),
                                          rng.normal(0, 0.02, 256)]
           ).astype(np.float32)
    return jcfg, tcfg, state, scans[-1], tstate, tscan, hyp


def test_matches_pallas_driver(mapped):
    jcfg, tcfg, jstate, jscan, tstate, tscan, hyp = mapped
    jres, _ = match_hypotheses_pallas(jstate.log_odds, jnp.asarray(hyp),
                                      jscan, jcfg, s_per=128,
                                      interpret=True, quads=jstate.quads)
    tres, diag = match_hypotheses_kernel(tstate.log_odds,
                                         torch.from_numpy(hyp), tscan, tcfg,
                                         quads=tstate.quads)
    err = np.abs(tres.pose.numpy() - np.asarray(jres.pose)).max()
    assert err < 2e-3, err
    assert tres.pose.shape == (256, 3) and tres.hessian.shape == (256, 3, 3)
    # every query stays on the kernel path: 256 hyp x 1152 beams x 10 steps
    assert float(diag.total_queries) == 256 * 1152 * 10
    assert float(diag.fast_path_fraction()) == 1.0
    assert int(diag.repaired_queries) == int(diag.overflow_steps) == 0


def test_quads_cache_and_level_subsets(mapped):
    """Results without the quads cache and through two single-level runs
    equal the full run (per-hypothesis numerics are order-independent)."""
    _, tcfg, _, _, tstate, tscan, hyp = mapped
    hyp_t = torch.from_numpy(hyp)
    full, _ = match_hypotheses_kernel(tstate.log_odds, hyp_t, tscan, tcfg,
                                      quads=tstate.quads)
    nocache, _ = match_hypotheses_kernel(tstate.log_odds, hyp_t, tscan,
                                         tcfg)
    assert torch.equal(full.pose, nocache.pose)
    coarse, _ = match_hypotheses_kernel(tstate.log_odds, hyp_t, tscan, tcfg,
                                        max_level=1, min_level=1)
    fine, _ = match_hypotheses_kernel(tstate.log_odds, coarse.pose, tscan,
                                      tcfg, max_level=0, min_level=0)
    assert torch.equal(fine.pose, full.pose)
    assert torch.equal(fine.hessian, full.hessian)


def test_hypothesis_count_not_a_multiple(mapped):
    """Any B works; the results of the first 200 of 256 hypotheses do not
    depend on the rest of the batch."""
    _, tcfg, _, _, tstate, tscan, hyp = mapped
    full, _ = match_hypotheses_kernel(tstate.log_odds, torch.from_numpy(hyp),
                                      tscan, tcfg, quads=tstate.quads)
    part, _ = match_hypotheses_kernel(tstate.log_odds,
                                      torch.from_numpy(hyp[:200]), tscan,
                                      tcfg, quads=tstate.quads)
    assert part.pose.shape == (200, 3)
    np.testing.assert_allclose(part.pose.numpy(), full.pose.numpy()[:200],
                               rtol=0, atol=1e-6)


def test_empty_scan_returns_input_pose():
    _, tcfg = _cfgs()
    state = ht.init_state(tcfg, device="cpu")
    scan = ht.Scan(points=torch.zeros((64, 2)), origo=torch.zeros(2),
                   mask=torch.zeros(64, dtype=torch.bool))
    hyp = torch.from_numpy(np.random.default_rng(3).normal(
        0, 0.1, (128, 3)).astype(np.float32))
    res, _ = match_hypotheses_kernel(state.log_odds, hyp, scan, tcfg)
    assert torch.equal(res.pose, hyp)
    assert (res.hessian == 0.0).all()


def test_gn_step_kernel_is_batched_gn_step(mapped):
    """One batched step equals the sequential matcher's gn_step applied
    to each hypothesis alone (same torch ops on the CPU)."""
    _, tcfg, _, _, tstate, tscan, hyp = mapped
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.core.matcher import gn_step
    est = world_to_map_pose(torch.from_numpy(hyp[:16]),
                            tcfg.map.top_left_offset,
                            tcfg.map.level_scale(0))
    quad = tstate.quads[0]
    before = im.interp_moments.launches
    new, hess = gn_step_kernel(quad, (H, W), est, tscan.points, tscan.mask)
    assert im.interp_moments.launches == before   # CPU: the plain version
    for i in range(16):
        e1, h1 = gn_step(quad, (H, W), est[i], tscan.points, tscan.mask)
        np.testing.assert_allclose(new[i].numpy(), e1.numpy(), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(hess[i].numpy(), h1.numpy(), rtol=1e-5,
                                   atol=1e-3)


def _level_world(tcfg, hyp, level):
    """The hypotheses as world poses, the last one moved onto an unmapped
    patch of ``level`` (every gradient and so H is 0: the guard fails)."""
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.core.matcher import finish_level
    est = world_to_map_pose(torch.from_numpy(hyp), tcfg.map.top_left_offset,
                            tcfg.map.level_scale(level))
    size = H >> level
    est[-1, :2] = torch.tensor([size - 6.0, size - 6.0])
    return finish_level(est, tcfg.map.top_left_offset,
                        tcfg.map.level_resolution(level))


def _level_inputs(tcfg, tstate, tscan, hyp, level):
    """The level's grid, its scan and the map-frame start estimates of
    ``_level_world``'s poses."""
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.core.matcher import level_points
    est = world_to_map_pose(_level_world(tcfg, hyp, level),
                            tcfg.map.top_left_offset,
                            tcfg.map.level_scale(level)).contiguous()
    return (tstate.quads[level], (H >> level, W >> level), est,
            level_points(tscan.points, level).contiguous(),
            tscan.mask.contiguous())


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("masked", ["none", "every_third", "all"])
def test_level_form_matches_pallas_driver(mapped, level, masked):
    """One pyramid level through interp_moments_level (its plain loop on
    the CPU) against JAX's Pallas driver run on that level alone, with one
    hypothesis on an unmapped patch and beams masked off. The plain loop
    is also the per-step route, gn_step_kernel, step for step, bit for
    bit. (Hypotheses at the map's edge are held bit-equal on the card;
    their ill-conditioned steps amplify any change of summation order, so
    JAX's driver, which sums in another order, is no bar for them.)"""
    from hector_slam_tpu_torch.core.matcher import finish_level
    jcfg, tcfg, jstate, jscan, tstate, tscan, hyp = mapped
    quad, shape, est, pts, mask = _level_inputs(tcfg, tstate, tscan, hyp,
                                                level)
    if masked == "every_third":
        mask = mask.clone()
        mask[::3] = False
    elif masked == "all":
        mask = torch.zeros_like(mask)
    world = _level_world(tcfg, hyp, level)
    jres, _ = match_hypotheses_pallas(
        jstate.log_odds, jnp.asarray(world.numpy()),
        jscan._replace(mask=jnp.asarray(mask.numpy())), jcfg, s_per=128,
        interpret=True, quads=jstate.quads, max_level=level,
        min_level=level)
    steps = (tcfg.match.iterations_finest if level == 0
             else tcfg.match.iterations_coarse) + 1
    before = im.interp_moments_level.launches
    got = im.interp_moments_level(quad, shape, est, pts, mask, steps)
    assert im.interp_moments_level.launches == before   # CPU: no launch
    want, hess = est, None
    for _ in range(steps):
        want, hess = gn_step_kernel(quad, shape, want, pts, mask)
    assert _bits_equal(got[0], want) and _bits_equal(got[1], hess)
    pose = finish_level(got[0], tcfg.map.top_left_offset,
                        tcfg.map.level_resolution(level)).numpy()
    jpose = np.asarray(jres.pose)
    assert (np.isnan(pose) == np.isnan(jpose)).all()
    err = np.nan_to_num(np.abs(pose - jpose)).max()
    assert err < 2e-3, err
    # the unmapped patch: H = 0, the guard fails, the estimate stays
    assert not got[1][-1].any() and torch.equal(got[0][-1], est[-1])
    if masked == "all":
        assert torch.equal(got[0], est) and not got[1].any()
    else:   # the hypotheses about the pose move
        assert bool((got[0][:-1] != est[:-1]).any(-1).all())


_FAULTS = {
    "dtype": (TypeError, lambda a: a.update(est=a["est"].double())),
    "shape": (ValueError, lambda a: a.update(est=a["est"][:, :2])),
    "contiguous": (ValueError, lambda a: a.update(
        pts=a["pts"].t().contiguous().t())),
    "mask_dtype": (TypeError, lambda a: a.update(mask=a["mask"].float())),
    "mask_length": (ValueError, lambda a: a.update(mask=a["mask"][1:])),
    "quad_shape": (ValueError, lambda a: a.update(shape=(H, W + 2))),
    "tiny_grid": (ValueError, lambda a: a.update(
        quad=a["quad"][:1].contiguous(), shape=(1, 1))),
    "too_many_beams": (ValueError, lambda a: a.update(
        pts=torch.zeros((im.MAX_POINTS + 1, 2)),
        mask=torch.ones(im.MAX_POINTS + 1, dtype=torch.bool))),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_level_input_checks_raise_as_interp_moments(mapped, fault):
    """The level form checks its inputs as interp_moments' kernel route
    does (prepare: the same exception and message, under its own name),
    on the CPU too."""
    _, tcfg, _, _, tstate, tscan, hyp = mapped
    quad, shape, est, pts, mask = _level_inputs(tcfg, tstate, tscan, hyp, 0)
    args = dict(quad=quad, shape=shape, est=est, pts=pts, mask=mask)
    err, fault_fn = _FAULTS[fault]
    fault_fn(args)
    order = ("quad", "shape", "est", "pts", "mask")
    with pytest.raises(err, match="^interp_moments: ") as want:
        im.prepare(*(args[k] for k in order))
    with pytest.raises(err, match="^interp_moments_level: ") as got:
        im.interp_moments_level(*(args[k] for k in order), 4)
    assert str(got.value) == str(want.value).replace(
        "interp_moments:", "interp_moments_level:", 1)


@pytest.mark.parametrize("steps", [0, -1, 2.5])
def test_level_steps_must_be_positive(mapped, steps):
    _, tcfg, _, _, tstate, tscan, hyp = mapped
    with pytest.raises(ValueError, match="steps"):
        im.interp_moments_level(*_level_inputs(tcfg, tstate, tscan, hyp, 0),
                                steps)
