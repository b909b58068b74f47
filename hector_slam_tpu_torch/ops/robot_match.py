"""One pyramid level of the SLAM step's matcher for R robots, each with its
own scan and its own map (or one shared map): the CUDA kernel
``csrc/robot_match.cu`` and its plain PyTorch version.

``robot_match_level`` runs a level's GN steps (moments, guard, adjugate
solve, clamp, pose update) for every robot in ONE launch, a block a robot
(see the kernel source for the design). It is the route of
``core/matcher.match_level`` for a single pose (R = 1) and for a fleet
with a scan a robot; hypotheses sharing one scan keep the warp-per-
hypothesis kernel (``ops/interp_moments.py``) or the torch ops. It
replaces the same TPU kernel, ``hector_slam_tpu/ops/pallas_interp.py:
interp_moments_pallas``. CUDA tensors launch the kernel (on the current
stream) or raise; CPU tensors run ``robot_match_level_plain``, the torch
loop the matcher ran before the kernel; there is no fallback from one to
the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.interp import hessian_derivs_quad
from . import cuda_build

MAX_POINTS = 24576        # beams one block stages in shared memory


def robot_match_level_plain(quads, shape, estimates_map, points, mask,
                            steps: int):
    """The kernel's function in torch ops: ``steps`` GN steps, each
    ``hessian_derivs_quad`` then ``guarded_step`` (``core/matcher.py``'s
    unsharded ``gn_step``)."""
    from ..core.matcher import guarded_step
    hess = None
    for _ in range(steps):
        hess, dtr = hessian_derivs_quad(quads, shape, estimates_map, points,
                                        mask)
        estimates_map = guarded_step(estimates_map, hess, dtr)
    return estimates_map, hess


def _check(quads, shape, estimates_map, points, mask, steps):
    what = "robot_match_level"
    if isinstance(steps, bool) or int(steps) != steps or steps < 1:
        raise ValueError(f"{what}: steps must be a positive integer, got "
                         f"{steps!r}")
    h, w = shape
    if h < 2 or w < 2:
        raise ValueError(f"{what}: grid {shape} is smaller than 2x2")
    if h * w > 2 ** 31 - 1:
        raise ValueError(f"{what}: grid {shape} has more than 2^31 - 1 "
                         "cells (the kernel indexes a grid's cells as i32)")
    if estimates_map.dim() != 2 or points.dim() != 3:
        raise ValueError(f"{what}: estimates_map must be [R, 3] and points "
                         f"[R, N, 2], got {tuple(estimates_map.shape)} and "
                         f"{tuple(points.shape)}")
    r, n = points.shape[:2]
    quad_shape = ((h * w, 4) if quads.dim() == 2 else (r, h * w, 4))
    dev = quads.device
    for name, t, dtype, want in (
            ("quads", quads, torch.float32, quad_shape),
            ("estimates_map", estimates_map, torch.float32, (r, 3)),
            ("points", points, torch.float32, (r, n, 2)),
            ("mask", mask, torch.bool, (r, n))):
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, quads on "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {want} (one grid, or one a robot)")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if n > MAX_POINTS:
        raise ValueError(f"{what}: {n} beams, the kernel stages at most "
                         f"{MAX_POINTS}")
    if quads.data_ptr() % 16 or points.data_ptr() % 8:
        raise ValueError(f"{what}: quads must be 16-byte and points 8-byte "
                         "aligned")


def _library():
    fn = cuda_build.load("robot_match").hs_robot_match_level
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, i, i, p, i, p, p, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def robot_match_level(
    quads: torch.Tensor,           # f32[H*W, 4] shared, or f32[R, H*W, 4]
    shape: Tuple[int, int],
    estimates_map: torch.Tensor,   # f32[R, 3] map-frame start estimates
    points: torch.Tensor,          # f32[R, N, 2] the level's beam endpoints
    mask: torch.Tensor,            # bool[R, N]
    steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` guarded GN steps of every robot on one pyramid level.
    Returns (estimates_map f32[R, 3] after the last step, hess f32[R, 3, 3]
    summed at the last step's start estimate). Both routes check their
    inputs alike."""
    _check(quads, shape, estimates_map, points, mask, steps)
    if quads.device.type == "cpu":
        return robot_match_level_plain(quads, shape, estimates_map, points,
                                       mask, int(steps))
    r, n = points.shape[:2]
    est = torch.empty((r, 3), dtype=torch.float32, device=quads.device)
    hess = torch.empty((r, 3, 3), dtype=torch.float32, device=quads.device)
    if r == 0:
        return est, hess
    stride = quads.shape[1] if quads.dim() == 3 else 0
    with torch.cuda.device(quads.device):
        rc = _library()(
            quads.data_ptr(), stride, shape[0], shape[1],
            estimates_map.data_ptr(), r, points.data_ptr(), mask.data_ptr(),
            n, int(steps), est.data_ptr(), hess.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"robot_match_level: kernel launch failed with "
                           f"CUDA error {rc}")
    robot_match_level.launches += 1
    return est, hess


robot_match_level.launches = 0   # kernel launches (core/graphs.py)
