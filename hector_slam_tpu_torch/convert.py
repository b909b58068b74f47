"""Carrying state across from numpy: the JAX package's arrays (handed over
as numpy, so neither package imports the other) become the port's
``SlamState``/``Scan``, for one robot or for a fleet. ``quads`` are
recomputed with the port's own ``quad_pack``, so both packages then
compute the same next step."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .config import SlamConfig
from .core.cell_models import storage_channels
from .core.slam import quads_of
from .types import Scan, SlamState, resolve_device


def _f32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dev)


def state_from_numpy(log_odds_levels: Sequence[np.ndarray], pose,
                     last_map_update_pose, covariance, step,
                     map_update_count, cfg: SlamConfig,
                     device="cuda") -> SlamState:
    """A ``SlamState`` on ``device`` (the card unless the caller asks for
    the CPU) from numpy arrays of the same fields."""
    dev = resolve_device(device)
    if len(log_odds_levels) != cfg.map.levels:
        raise ValueError(f"{len(log_odds_levels)} levels given, config has "
                         f"{cfg.map.levels}")
    log_odds = tuple(_f32(lo, dev) for lo in log_odds_levels)
    return SlamState(
        log_odds=log_odds,
        pose=_f32(pose, dev).reshape(3),
        last_map_update_pose=_f32(last_map_update_pose, dev).reshape(3),
        covariance=_f32(covariance, dev).reshape(3, 3),
        step=torch.tensor(int(step), dtype=torch.int32, device=dev),
        map_update_count=torch.tensor(int(map_update_count),
                                      dtype=torch.int32, device=dev),
        quads=quads_of(log_odds, cfg.update.cell_model),
    )


def fleet_state_from_numpy(log_odds_levels: Sequence[np.ndarray], pose,
                           last_map_update_pose, covariance, step,
                           map_update_count, cfg: SlamConfig,
                           device="cuda") -> SlamState:
    """A fleet's ``SlamState`` on ``device`` from numpy arrays of the same
    fields, in either layout of the JAX package, told apart by the levels:
      - per-robot maps (``init_fleet``/``fleet_step``): levels [R, H, W]
        (reflectance [R, 2, H, W]), and every other leaf with a leading R
        axis (pose [R, 3], covariance [R, 3, 3], step and count [R]);
      - one shared map (``init_shared_fleet``/``shared_fleet_step``):
        levels [H, W], pose, gate pose [R, 3] and covariance [R, 3, 3],
        step and count scalars."""
    dev = resolve_device(device)
    if len(log_odds_levels) != cfg.map.levels:
        raise ValueError(f"{len(log_odds_levels)} levels given, config has "
                         f"{cfg.map.levels}")
    pose = _f32(pose, dev)
    if pose.dim() != 2 or pose.shape[1] != 3:
        raise ValueError(f"fleet poses must be [R, 3], got "
                         f"{tuple(pose.shape)}")
    r = pose.shape[0]
    grid_dims = 2 if storage_channels(cfg.update.cell_model) == 1 else 3
    per_robot = np.ndim(log_odds_levels[0]) == grid_dims + 1
    log_odds = tuple(_f32(lo, dev) for lo in log_odds_levels)
    lead = (r,) if per_robot else ()
    for level, lo in enumerate(log_odds):
        sx, sy = cfg.map.level_size(level)
        if (lo.dim() != len(lead) + grid_dims or lo.shape[:len(lead)] != lead
                or tuple(lo.shape[-2:]) != (sy, sx)):
            raise ValueError(f"level {level} has shape {tuple(lo.shape)}; "
                             f"expected {lead} + ... + {(sy, sx)}")

    def i32(a):
        return torch.from_numpy(np.array(a, np.int32).reshape(lead)).to(dev)

    return SlamState(
        log_odds=log_odds,
        pose=pose,
        last_map_update_pose=_f32(last_map_update_pose, dev).reshape(r, 3),
        covariance=_f32(covariance, dev).reshape(r, 3, 3),
        step=i32(step),
        map_update_count=i32(map_update_count),
        quads=quads_of(log_odds, cfg.update.cell_model),
    )


def scan_from_numpy(points, origo, mask, device="cuda") -> Scan:
    """A ``Scan`` on ``device`` from numpy points f32[N,2], origo f32[2]
    and mask bool[N], or with a leading axis on all three: a time axis
    for ``run_log``, a robot axis ([R, N, 2], [R, 2], [R, N]) for the
    fleet steps."""
    dev = resolve_device(device)
    return Scan(points=_f32(points, dev), origo=_f32(origo, dev),
                mask=torch.from_numpy(np.array(mask, bool)).to(dev))
