"""The moments kernel's plain version (ops/interp_moments.py) against the
JAX package on the CPU, on the workload of tests/test_pallas_match.py
(256^2 random grid, B=256 hypotheses, N=64 beams with the tail masked):

  (a) JAX ``interp_moments_pallas(..., interpret=True)`` followed by
      ``repair_moments`` — the TPU kernel's totals after its repair;
  (b) vmapped ``hessian_derivs_quad`` — the exact-semantics quad path;
  (c) a float64 oracle of the cited formulas: the plain version must be
      at least as accurate as the quad path.

Tolerances: both packages evaluate the same f32 expressions (given
equal sin/cos the JAX transform is bit-equal to the port's), but XLA's
sin and cos differ from torch's by 1 ulp on some angles, which moves
tx/ty by an ulp, so a query near a cell edge can floor to the
neighbouring cell. With the f32 summation order, the moments are held to
5e-5 of the batch's largest |moment|, and the used counts exactly. The
CUDA kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py), where kernel and plain version see the same f32 inputs
and are held to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hector_slam_tpu.core.interp import hessian_derivs_quad, quad_pack
from hector_slam_tpu.ops.pallas_interp import (interp_moments_pallas,
                                               repair_moments)

from hector_slam_tpu_torch.core.interp import quad_pack as t_quad_pack
from hector_slam_tpu_torch.ops import interp_moments as im

H = W = 256
TOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _workload(seed, n=64, b=256, sigma_xy=1.0, sigma_t=0.02, theta=0.3):
    rng = np.random.default_rng(seed)
    grid = rng.random((H, W)).astype(np.float32)
    ang = np.linspace(-2.0, 2.0, n)
    r = 60.0 + 10 * np.sin(5 * ang)
    pts = np.c_[r * np.cos(ang), r * np.sin(ang)].astype(np.float32)
    mask = np.r_[np.ones(n - 4, bool), np.zeros(4, bool)]
    base = np.array([128.0, 128.0, theta], np.float32)
    poses = (base + np.c_[rng.normal(0, sigma_xy, (b, 2)),
                          rng.normal(0, sigma_t, b)]).astype(np.float32)
    return grid, pts, mask, poses[np.argsort(poses[:, 2])]


def _oracle_f64(grid, poses, pts, mask):
    """getCompleteHessianDerivs in float64 (tests/test_pallas_match.py),
    with the cells chosen by the port's f32 transform (a f64 transform can
    floor a boundary query to another cell: an input-rounding artifact,
    not an accumulation error), so only interpolation and accumulation
    accuracy are measured."""
    g = grid.astype(np.float64)
    pt = pts.astype(np.float64)
    pose_t = torch.from_numpy(poses)
    s32 = torch.sin(pose_t[:, 2:3])
    c32 = torch.cos(pose_t[:, 2:3])
    px, py = torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1])
    tx = (c32 * px + (-s32 * py + pose_t[:, 0:1])).double().numpy()
    ty = (s32 * px + (c32 * py + pose_t[:, 1:2])).double().numpy()
    s, c = s32[:, 0].double().numpy(), c32[:, 0].double().numpy()
    inb = ((tx >= 0) & (tx <= W - 2) & (ty >= 0) & (ty <= H - 2)
           & mask[None, :])
    xi = np.clip(tx.astype(np.int64), 0, W - 2)
    yi = np.clip(ty.astype(np.int64), 0, H - 2)
    fx, fy = tx - xi, ty - yi
    p00, p10 = g[yi, xi], g[yi, xi + 1]
    p01, p11 = g[yi + 1, xi], g[yi + 1, xi + 1]
    val = (p00 * (1 - fx) + p10 * fx) * (1 - fy) + \
        (p01 * (1 - fx) + p11 * fx) * fy
    gx = -((p00 - p10) * (1 - fx) + (p01 - p11) * fx)
    gy = -((p00 - p01) * (1 - fy) + (p10 - p11) * fy)
    val, gx, gy = [np.where(inb, a, 0.0) for a in (val, gx, gy)]
    rot = ((-s[:, None] * pt[None, :, 0] - c[:, None] * pt[None, :, 1]) * gx
           + (c[:, None] * pt[None, :, 0] - s[:, None] * pt[None, :, 1])
           * gy)
    jac = np.stack([gx, gy, rot], -1)
    return (np.einsum("bnj,bnk->bjk", jac, jac),
            np.einsum("bnj,bn->bj", jac, 1 - val), inb.sum(-1))


def _plain(grid, pts, mask, poses):
    return im.interp_moments(t_quad_pack(torch.from_numpy(grid)), (H, W),
                             torch.from_numpy(poses), torch.from_numpy(pts),
                             torch.from_numpy(mask))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("spread", ["tight", "wide"])
def test_plain_matches_pallas_kernel_after_repair(spread):
    sig = (0.5, 0.005) if spread == "tight" else (12.0, 0.05)
    grid, pts, mask, poses = _workload(31, sigma_xy=sig[0],
                                       sigma_t=sig[1])
    quad = quad_pack(jnp.asarray(grid))
    mom = interp_moments_pallas(jnp.asarray(grid), (H, W),
                                jnp.asarray(poses), jnp.asarray(pts),
                                jnp.asarray(mask), s_per=128, interpret=True)
    hk, dk, n_bad, ovf = repair_moments(
        quad, (H, W), jnp.asarray(poses), jnp.asarray(pts),
        jnp.asarray(mask), mom.hess, mom.dtr, k_budget=32768, s_per=128,
        wr=24, wc=256)
    assert not bool(ovf)
    if spread == "wide":
        assert int(n_bad) > 0, "the wide spread must exercise the repair"
    got = _plain(grid, pts, mask, poses)
    assert _rel(got.hess.numpy(), np.asarray(hk)) < TOL
    assert _rel(got.dtr.numpy(), np.asarray(dk)) < TOL
    # the TPU kernel's fast-path count plus its repaired queries is the
    # count of in-bounds valid queries
    assert int(got.used.sum()) == int(mom.used.sum()) + int(n_bad)


@pytest.mark.parametrize("spread", ["tight", "wide"])
def test_plain_matches_vmapped_quad_path(spread):
    sig = (0.5, 0.005) if spread == "tight" else (12.0, 0.05)
    grid, pts, mask, poses = _workload(32, sigma_xy=sig[0],
                                       sigma_t=sig[1])
    quad = quad_pack(jnp.asarray(grid))
    hq, dq = jax.vmap(lambda p: hessian_derivs_quad(
        quad, (H, W), p, jnp.asarray(pts), jnp.asarray(mask)))(
            jnp.asarray(poses))
    got = _plain(grid, pts, mask, poses)
    assert _rel(got.hess.numpy(), np.asarray(hq)) < TOL
    assert _rel(got.dtr.numpy(), np.asarray(dq)) < TOL
    np.testing.assert_array_equal(got.hess.numpy(),
                                  got.hess.numpy().transpose(0, 2, 1))


def test_plain_at_least_as_accurate_as_quad_path():
    grid, pts, mask, poses = _workload(33)
    quad = quad_pack(jnp.asarray(grid))
    hq, dq = jax.vmap(lambda p: hessian_derivs_quad(
        quad, (H, W), p, jnp.asarray(pts), jnp.asarray(mask)))(
            jnp.asarray(poses))
    got = _plain(grid, pts, mask, poses)
    ho, do, used = _oracle_f64(grid, poses, pts, mask)
    err_p, err_q = _rel(got.hess.numpy(), ho), _rel(np.asarray(hq), ho)
    errd_p, errd_q = _rel(got.dtr.numpy(), do), _rel(np.asarray(dq), do)
    assert err_p < 1e-4 and errd_p < 1e-4
    # same slack as the TPU kernel's check (tests/test_pallas_match.py)
    assert err_p <= 2 * err_q + 1e-6
    assert errd_p <= 2 * errd_q + 1e-6
    np.testing.assert_array_equal(got.used.numpy(), used.astype(np.float32))


def test_wrapper_checks_inputs():
    grid, pts, mask, poses = _workload(34, b=8)
    quad = t_quad_pack(torch.from_numpy(grid))
    args = (quad, (H, W), torch.from_numpy(poses), torch.from_numpy(pts),
            torch.from_numpy(mask))
    im._check(*args)
    with pytest.raises(TypeError):
        im._check(quad.double(), *args[1:])
    with pytest.raises(ValueError):
        im._check(quad, (H, W - 1), *args[2:])
    with pytest.raises(ValueError):
        im._check(quad, (H, W), args[2].t(), *args[3:])
    with pytest.raises(ValueError):
        im._check(*args[:4], torch.from_numpy(mask[:-1]))
