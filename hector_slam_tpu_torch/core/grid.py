"""Grid geometry: world<->map transforms, angle normalization, the
map-update gate predicate and the pyramid reset.

Counterpart of ``hector_slam_tpu/core/grid.py`` (the reference's
GridMapBase transform math, map/GridMapBase.h:265-280). Every constant is
rounded to float32 on the host first (``_f32``), so each op runs in f32
and rounds exactly as the JAX expression does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MapConfig
from ..types import resolve_device
from .cell_models import init_fill, storage_channels


def _f32(x) -> float:
    """A Python float that is exactly an f32 value (torch casts a Python
    scalar operand to the tensor's f32, so this pins the rounding)."""
    return float(np.float32(x))


def world_to_map(xy: torch.Tensor, offset, scale) -> torch.Tensor:
    """mapTworld = Scaling(1/cell) * Translation(offset) (GridMapBase.h:272),
    composed as Eigen composes it: map = s*w + (s*o), with s*o rounded in
    f32 (not (w+o)*s, which can flip a Bresenham cell at a .5 boundary)."""
    s = np.float32(scale)
    off = np.asarray(offset, np.float32) * s       # f32 products, as XLA
    return xy * float(s) + torch.tensor(off, dtype=torch.float32,
                                        device=xy.device)


def map_to_world(xy: torch.Tensor, offset, cell_length) -> torch.Tensor:
    """worldTmap = mapTworld.inverse() (GridMapBase.h:279), Eigen's 2x2
    affine inversion in f32: invdet = 1/(s*s), linear_inv = s*invdet and
    translation_inv = -linear_inv * (s*o)."""
    s = np.float32(1.0) / np.float32(cell_length)   # scaleToMap
    inv_det = np.float32(1.0) / (s * s)
    inv_s = s * inv_det
    t = np.asarray(offset, np.float32) * s
    return xy * float(inv_s) - torch.tensor(inv_s * t, dtype=torch.float32,
                                            device=xy.device)


def world_to_map_pose(pose: torch.Tensor, offset, scale) -> torch.Tensor:
    """Pose transforms touch x,y only; theta passes through
    (GridMapBase.h:235-239)."""
    m = world_to_map(pose[..., :2], offset, scale)
    return torch.cat([m, pose[..., 2:]], dim=-1)


def map_to_world_pose(pose: torch.Tensor, offset, cell_length) -> torch.Tensor:
    w = map_to_world(pose[..., :2], offset, cell_length)
    return torch.cat([w, pose[..., 2:]], dim=-1)


# two-float split of the double 2*pi (f64(2*pi) == _TWO_PI_HI + _TWO_PI_LO
# to f64 precision): emulates the reference's double-precision angle
# arithmetic in f32 (hector_slam_tpu/core/grid.py:63-75)
_TWO_PI_D = 2.0 * float(np.float64(np.pi))
_TWO_PI_HI = np.float32(_TWO_PI_D)
_TWO_PI_LO = np.float32(_TWO_PI_D - float(_TWO_PI_HI))
# largest f32 <= f64 pi: the f32 compare `a > _PI_LOW32` equals the
# reference's double compare `a > M_PI`
_PI_LOW32 = np.float32(np.nextafter(np.float32(np.pi), np.float32(0.0))) \
    if float(np.float32(np.pi)) > float(np.float64(np.pi)) \
    else np.float32(np.pi)
_PI32 = np.float32(np.pi)


def _add_twofloat(a: torch.Tensor, hi, lo) -> torch.Tensor:
    """Correctly rounded f32(a + (hi+lo)) via 2Sum compensation."""
    hi, lo = float(hi), float(lo)
    s = a + hi
    bv = s - a
    err = (a - (s - bv)) + (hi - bv)   # exact f32 rounding error of a+hi
    return s + (err + lo)


def normalize_angle(angle: torch.Tensor) -> torch.Tensor:
    """util/UtilFunctions.h:37-49, whose fmod chain runs in DOUBLE and
    rounds to float once: emulated with two-float compensated adds, as
    ``hector_slam_tpu/core/grid.py:normalize_angle`` does. Inputs beyond
    +-2*pi first get a coarse f32 wrap."""
    two_pi = float(_TWO_PI_HI)
    a = torch.where(angle.abs() >= two_pi, torch.fmod(angle, two_pi), angle)
    pos = torch.where(a < 0.0, _add_twofloat(a, _TWO_PI_HI, _TWO_PI_LO), a)
    return torch.where(pos > float(_PI_LOW32),
                       _add_twofloat(pos, -_TWO_PI_HI, -_TWO_PI_LO), pos)


def pose_difference_larger_than(pose1: torch.Tensor, pose2: torch.Tensor,
                                dist_thresh, angle_thresh) -> torch.Tensor:
    """Map-update gate predicate (util/UtilFunctions.h:73-92), for poses
    f32[..., 3] (one gate per robot of a fleet)."""
    d = pose1[..., :2] - pose2[..., :2]
    dd = d * d
    dist_exceeded = torch.sqrt(dd[..., 0] + dd[..., 1]) > _f32(dist_thresh)
    angle_diff = pose1[..., 2] - pose2[..., 2]
    pi = float(_PI32)
    two_pi = float(np.float32(2) * _PI32)
    angle_diff = torch.where(angle_diff > pi, angle_diff - two_pi, angle_diff)
    angle_diff = torch.where(angle_diff < -pi, angle_diff + two_pi,
                             angle_diff)
    return dist_exceeded | (angle_diff.abs() > _f32(angle_thresh))


def init_log_odds_pyramid(cfg: MapConfig, cell_model: str = "log_odds",
                          device="cuda"):
    """Freshly reset pyramid (resetGridCell semantics per cell model:
    log-odds 0, probability models 0.5, reflectance zero counters), on
    the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    fill = init_fill(cell_model)
    channels = storage_channels(cell_model)
    grids = []
    for lvl in range(cfg.levels):
        sx, sy = cfg.level_size(lvl)
        if channels == 1:
            grids.append(torch.full((sy, sx), fill, dtype=torch.float32,
                                    device=device))
        else:
            grids.append(torch.zeros((channels, sy, sx), dtype=torch.float32,
                                     device=device))
    return tuple(grids)
