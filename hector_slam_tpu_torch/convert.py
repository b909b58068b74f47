"""Carrying state across from numpy: the JAX package's arrays (handed over
as numpy, so neither package imports the other) become the port's
``SlamState``/``Scan``. ``quads`` are recomputed with the port's own
``quad_pack``, so both packages then compute the same next step."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .config import SlamConfig
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


def scan_from_numpy(points, origo, mask, device="cuda") -> Scan:
    """A ``Scan`` on ``device`` from numpy points f32[N,2], origo f32[2]
    and mask bool[N] (or with a leading time axis on all three)."""
    dev = resolve_device(device)
    return Scan(points=_f32(points, dev), origo=_f32(origo, dev),
                mask=torch.from_numpy(np.array(mask, bool)).to(dev))
