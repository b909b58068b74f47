"""Batched interpolation + normal-equation moments: the CUDA kernel
``csrc/interp_moments.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``hector_slam_tpu/ops/pallas_interp.py:
interp_moments_pallas`` together with its granular repair: for every
hypothesis the nine moments of J^T J and J^T (1-M) over all beams, the
totals vmapped ``hessian_derivs_quad`` gives (see the kernel source for
the design). ``interp_moments`` launches the kernel for CUDA tensors and
runs ``interp_moments_plain`` only for CPU tensors; there is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..core.interp import assemble_hessian, normal_eqs_quad
from . import cuda_build

_OUT = 10   # 9 moments + used count per hypothesis


class Moments(NamedTuple):
    hess: torch.Tensor   # f32[B, 3, 3]
    dtr: torch.Tensor    # f32[B, 3]
    used: torch.Tensor   # f32[B] in-bounds valid queries per hypothesis


def interp_moments_plain(
    quad: torch.Tensor,        # f32[H*W, 4] quad-packed prob grid
    shape: Tuple[int, int],
    poses_map: torch.Tensor,   # f32[B, 3] map-frame poses
    points: torch.Tensor,      # f32[N, 2] beam endpoints (map scale)
    mask: torch.Tensor,        # bool[N]
) -> Moments:
    """The kernel's function in batched torch ops: a gather of quad[idx]
    into [B, N, 4] and sums over the beam axis."""
    return Moments(*normal_eqs_quad(quad, shape, poses_map, points, mask))


def _check(quad, shape, poses_map, points, mask):
    h, w = shape
    dev = quad.device
    for name, t, dtype, want in (
            ("quad", quad, torch.float32, (h * w, 4)),
            ("poses_map", poses_map, torch.float32, (poses_map.shape[0], 3)),
            ("points", points, torch.float32, (points.shape[0], 2)),
            ("mask", mask, torch.bool, (points.shape[0],))):
        if t.device != dev:
            raise ValueError(f"interp_moments: {name} is on {t.device}, "
                             f"quad on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"interp_moments: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"interp_moments: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"interp_moments: {name} must be contiguous")
    if h < 2 or w < 2:
        raise ValueError(f"interp_moments: grid {shape} is smaller than 2x2")
    if quad.data_ptr() % 16 or points.data_ptr() % 8:
        raise ValueError("interp_moments: quad must be 16-byte and points "
                         "8-byte aligned")


def _library():
    lib = cuda_build.load("interp_moments")
    fn = lib.hs_interp_moments
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, p, i, p, p, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(quad, shape, poses_map, sin_t, cos_t, points, mask, out):
    """The bare kernel launch on checked, prepared CUDA buffers (``out``
    f32[B, 10]); raises if the launch is refused. Not counted: callers
    other than ``interp_moments`` only time the kernel with it."""
    with torch.cuda.device(quad.device):
        rc = _library()(quad.data_ptr(), shape[0], shape[1],
                        poses_map.data_ptr(), sin_t.data_ptr(),
                        cos_t.data_ptr(), poses_map.shape[0],
                        points.data_ptr(), mask.data_ptr(), points.shape[0],
                        out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"interp_moments: kernel launch failed with CUDA "
                           f"error {rc}")


def prepare(quad, shape, poses_map, points, mask):
    """Checks the inputs and returns the launch buffers (sin, cos, out):
    sin/cos exactly as the plain version computes them, so both see the
    same f32 inputs."""
    _check(quad, shape, poses_map, points, mask)
    sin_t = torch.sin(poses_map[:, 2]).contiguous()
    cos_t = torch.cos(poses_map[:, 2]).contiguous()
    out = torch.empty((poses_map.shape[0], _OUT), dtype=torch.float32,
                      device=quad.device)
    return sin_t, cos_t, out


def interp_moments(
    quad: torch.Tensor,
    shape: Tuple[int, int],
    poses_map: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
) -> Moments:
    """Moments of every hypothesis. CPU tensors take the plain version;
    CUDA tensors launch the kernel (on the current stream) or raise."""
    if quad.device.type == "cpu":
        return interp_moments_plain(quad, shape, poses_map, points, mask)
    sin_t, cos_t, out = prepare(quad, shape, poses_map, points, mask)
    _launch(quad, shape, poses_map, sin_t, cos_t, points, mask, out)
    interp_moments.launches += 1
    return Moments(assemble_hessian(*out[:, :6].unbind(-1)),
                   out[:, 6:9], out[:, 9])


interp_moments.launches = 0   # kernel launches, for chip_smoke.py
