"""Sigma-point pose covariance and match likelihood/residual — the
OccGridMapUtil auxiliary estimators (OccGridMapUtil.h:106-221).

Counterpart of ``hector_slam_tpu/core/covariance.py``. The reference's
main path never calls these; they are part of the library surface. The 7
sigma points are scored as one [7, N] batch of queries through
``interp_with_derivatives`` (the JAX package vmaps the same evaluation).
``sigma_point_covariance_jit`` is the JAX package's jitted covariance
(hector_slam_tpu/core/covariance.py:77): on the card a CUDA graph
(core/graphs.py), the map held and the pose and scan copied.
"""

from __future__ import annotations

import torch

from ..types import Scan
from . import graphs
from .grid import device_constant
from .interp import beam_sum, interp_with_derivatives

# sigma-point offsets of getCovarianceForPose (OccGridMapUtil.h:106-160):
# +-1.5 cells on x and y, +-0.05 rad on the heading, and the pose itself
_DT = 1.5
_DA = 0.05
_SIGMA_OFFSETS = ((_DT, 0.0, 0.0), (-_DT, 0.0, 0.0), (0.0, _DT, 0.0),
                  (0.0, -_DT, 0.0), (0.0, 0.0, _DA), (0.0, 0.0, -_DA),
                  (0.0, 0.0, 0.0))


def residual_for_state(log_odds: torch.Tensor, pose_map: torch.Tensor,
                       scan: Scan, cell_model: str = "log_odds"
                       ) -> torch.Tensor:
    """sum(1 - M) over the valid beams (getResidualForState, :204-221),
    for a map-frame pose f32[3] (-> f32[]) or a batch f32[S, 3] (->
    f32[S])."""
    s = torch.sin(pose_map[..., 2:3])
    c = torch.cos(pose_map[..., 2:3])
    px, py = scan.points[:, 0], scan.points[:, 1]
    # Eigen affine fold order: m00*px + (m01*py + t), as the matcher's
    # transform (core/interp.normal_eqs_quad)
    tx = c * px + (-s * py + pose_map[..., 0:1])
    ty = s * px + (c * py + pose_map[..., 1:2])
    m, _, _ = interp_with_derivatives(log_odds, torch.stack([tx, ty], -1),
                                      cell_model)
    return beam_sum(torch.where(scan.mask, 1.0 - m, 0.0))


def likelihood_for_state(log_odds: torch.Tensor, pose_map: torch.Tensor,
                         scan: Scan, cell_model: str = "log_odds"
                         ) -> torch.Tensor:
    """1 - residual/numPoints (getLikelihoodForState, :189-202); an empty
    scan counts one point, so it reads 1."""
    resid = residual_for_state(log_odds, pose_map, scan, cell_model)
    n = torch.clamp(scan.mask.sum().to(torch.float32), min=1.0)
    return 1.0 - resid / n


def sigma_point_covariance(log_odds: torch.Tensor, pose_map: torch.Tensor,
                           scan: Scan, cell_model: str = "log_odds"
                           ) -> torch.Tensor:
    """getCovarianceForPose (OccGridMapUtil.h:106-160): 7 sigma points
    weighted by their match likelihood; the weighted scatter matrix f32[3,
    3] in map coordinates. Each entry is w * (d_i * d_j), so the result is
    exactly symmetric."""
    offsets = device_constant(_SIGMA_OFFSETS, pose_map.device)
    sigma = pose_map + offsets                                  # [7, 3]
    lh = likelihood_for_state(log_odds, sigma, scan, cell_model)
    inv_norm = 1.0 / lh.sum()
    mean = (sigma * lh[:, None]).sum(0) * inv_norm
    d = sigma - mean
    w = lh * inv_norm
    return (w[:, None, None] * (d[:, :, None] * d[:, None, :])).sum(0)


def sigma_point_covariance_jit(log_odds: torch.Tensor,
                               pose_map: torch.Tensor, scan: Scan,
                               cell_model: str = "log_odds") -> torch.Tensor:
    """``sigma_point_covariance`` compiled (static ``cell_model``): on the
    card a CUDA graph captured once per (``cell_model``, shapes, the
    map's memory) and replayed with no host round trip; the covariance
    is a new tensor, bit-equal to the eager function's. On CPU tensors it
    runs eagerly."""
    if not graphs.on_card(pose_map):
        return sigma_point_covariance(log_odds, pose_map, scan, cell_model)
    return graphs.call(
        "sigma_point_covariance_jit", (cell_model,), [log_odds],
        [pose_map, *scan],
        lambda maps, statics: sigma_point_covariance(
            maps[0], statics[0], Scan(*statics[1:4]), cell_model))


def interp_map_value(log_odds: torch.Tensor, coords: torch.Tensor,
                     cell_model: str = "log_odds") -> torch.Tensor:
    """Plain bilinear value without gradients (interpMapValue,
    OccGridMapUtil.h:233-285) at map coords f32[..., 2]."""
    m, _, _ = interp_with_derivatives(log_odds, coords, cell_model)
    return m
