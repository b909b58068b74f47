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
