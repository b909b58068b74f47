"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same CUDA tensors. Every test here carries the
``cuda`` marker and skips (inside a fixture) without a card.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only the port; ``tests/conftest.py`` imports JAX, so
skip it there:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance: the kernel is built with -fmad=false and takes the wrapper's
sin/cos, so its per-query terms are the plain version's; only the f32
summation order differs. Moments are held to 1e-5 of the batch's largest
|moment| and the used counts exactly, as chip_smoke.py holds them."""

import numpy as np
import pytest
import torch

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core.interp import quad_pack
from hector_slam_tpu_torch.io.simulator import World, simulate_trajectory
from hector_slam_tpu_torch.ops import interp_moments as im

TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _moments_inputs(dev, b, n, n_valid, size=256, seed=35):
    """A random grid, a ring of beams (some beyond the map edge) and b
    poses around the centre with a wide spread."""
    rng = np.random.default_rng(seed)
    grid = rng.random((size, size), dtype=np.float32)
    ang = np.linspace(-2.356, 2.356, n).astype(np.float32)
    rad = rng.uniform(0.02, 0.6, n).astype(np.float32) * size
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    poses = np.c_[size / 2 + rng.normal(0, 12.0, (b, 2)),
                  rng.normal(0, 0.05, b)].astype(np.float32)
    return (quad_pack(torch.from_numpy(grid).to(dev)), (size, size),
            torch.from_numpy(poses).to(dev),
            torch.from_numpy(pts.astype(np.float32)).to(dev),
            torch.from_numpy(np.arange(n) < n_valid).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,n_valid", [(512, 64, 60), (1, 1152, 1081),
                                         (3, 200, 0)])
def test_kernel_matches_plain_on_card(cuda_device, b, n, n_valid):
    args = _moments_inputs(cuda_device, b, n, n_valid)
    before = im.interp_moments.launches
    k = im.interp_moments(*args)
    assert im.interp_moments.launches == before + 1
    p = im.interp_moments_plain(*args)
    assert torch.equal(k.used, p.used)
    if n_valid == 0:
        assert not k.hess.any() and not k.dtr.any()
        return
    assert _rel(k.hess, p.hess) < TOL
    assert _rel(k.dtr, p.dtr) < TOL
    again = im.interp_moments(*args)
    assert all(torch.equal(x, y) for x, y in zip(k, again))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda_device):
    quad, shape, poses, pts, mask = _moments_inputs(cuda_device, 8, 64, 64)
    with pytest.raises(ValueError):
        im.interp_moments(quad, shape, poses.cpu(), pts, mask)
    with pytest.raises(ValueError):
        im.interp_moments(quad, shape, poses, pts.t().contiguous().t(), mask)
    with pytest.raises(TypeError):
        im.interp_moments(quad, shape, poses.double(), pts, mask)


@pytest.mark.cuda
def test_batched_match_through_kernel_on_card(cuda_device):
    """A small map built on the card with known poses; 64 hypotheses
    matched through the kernel (one launch per GN step) and through the
    plain batched matcher agree."""
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=256,
                                         size_y=256, levels=2),
                        max_ray_cells=256)
    laser = ht.LaserModel(num_beams=181, angle_min=-1.57,
                          angle_increment=np.pi / 180, range_max=8.0)
    poses_true = np.zeros((8, 3), np.float32)
    poses_true[:, 0] = np.linspace(0, 0.4, 8)
    ranges = simulate_trajectory(World.corridor(length=8.0, width=3.0),
                                 poses_true, laser, range_noise_std=0.0)
    scans = [ht.scan_from_ranges(r, cfg.map.level_scale(0), laser,
                                 cfg.max_beams, device=cuda_device)
             for r in ranges]
    state = ht.init_state(cfg, device=cuda_device)
    for sc, pose in zip(scans, poses_true):
        state, _ = ht.slam_step(state, sc, cfg,
                                pose_hint=torch.from_numpy(pose).to(
                                    cuda_device),
                                map_without_matching=True)
    rng = np.random.default_rng(7)
    hyp = torch.from_numpy((poses_true[-1] + np.c_[
        rng.normal(0, 0.03, (64, 2)), rng.normal(0, 0.02, 64)]).astype(
            np.float32)).to(cuda_device)
    before = im.interp_moments.launches
    got, diag = ht.match_hypotheses_kernel(state.log_odds, hyp, scans[-1],
                                           cfg, quads=state.quads)
    steps = (cfg.match.iterations_finest + 1) + (
        cfg.match.iterations_coarse + 1)
    assert im.interp_moments.launches == before + steps
    want = ht.match_pyramid(state.log_odds, hyp, scans[-1], cfg,
                            quads=state.quads)
    diff = (got.pose - want.pose).abs().max(-1).values.cpu().numpy()
    assert np.isfinite(got.pose.cpu().numpy()).all()
    assert np.percentile(diff, 90) < 2e-3
    assert float(diag.slow_queries) == 0.0
