"""Cell models: how per-cell storage maps to probability and how the
per-scan free/occupied sets update it.

Counterpart of ``hector_slam_tpu/core/cell_models.py`` — the reference's
three cell types (map/GridMapLogOdds.h, map/GridMapSimpleCount.h,
map/GridMapReflectanceCount.h), selected by ``UpdateConfig.cell_model``:

  - ``log_odds`` (default): f32 log-odds per cell, init 0; prob =
    odds/(odds+1); free add unclamped, occupied add clamped at 50.
  - ``simple_count``: probability stored directly, init 0.5; +0.15
    occupied below ``1 - 0.15 - 0.15/100``, -0.10 free above
    ``0.10 - 0.10/100``, both tested on the value before this scan.
  - ``reflectance``: (visited, reflected) counters as a [2, H, W] tensor;
    prob = reflected/visited (0.5 before any visit).
"""

from __future__ import annotations

import numpy as np
import torch

LOG_ODDS = "log_odds"
SIMPLE_COUNT = "simple_count"
REFLECTANCE = "reflectance"
# the grid already stores probabilities (a precomputed prob grid)
PROB = "prob"

# GridMapSimpleCountFunctions (GridMapSimpleCount.h:101-108)
_SC_FREE = np.float32(-0.10)
_SC_OCC = np.float32(0.15)
_SC_FREE_LIMIT = np.float32(-_SC_FREE + _SC_FREE / np.float32(100.0))
_SC_OCC_LIMIT = np.float32(1.0) - (_SC_OCC + _SC_OCC / np.float32(100.0))
_OCC_CLAMP = 50.0


def init_fill(model: str) -> float:
    """resetGridCell value (log-odds 0; probability models 0.5)."""
    return 0.0 if model == LOG_ODDS else 0.5


def storage_channels(model: str) -> int:
    return 2 if model == REFLECTANCE else 1


def storage_to_prob(values: torch.Tensor, model: str) -> torch.Tensor:
    """Gathered storage values -> probability (getGridProbability)."""
    if model == LOG_ODDS:
        odds = torch.exp(values)
        return odds / (odds + 1.0)
    if model in (SIMPLE_COUNT, PROB):
        return values
    raise ValueError(f"gather-path prob undefined for {model}; use "
                     "reflectance_prob_grid first")


def prob_grid(storage: torch.Tensor, model: str) -> torch.Tensor:
    """Whole-grid storage -> probability conversion, once per map epoch
    (the dense replacement for the reference's lazy per-cell cache,
    map/GridMapCacheArray.h:80-90)."""
    if model == REFLECTANCE:
        return reflectance_prob_grid(storage)
    if model in (LOG_ODDS, SIMPLE_COUNT, PROB):
        return storage_to_prob(storage, model)
    raise ValueError(f"unknown cell model {model!r}")


def reflectance_prob_grid(storage: torch.Tensor) -> torch.Tensor:
    """[..., 2, H, W] (visited, reflected) -> prob grid [..., H, W]; cells
    never visited read 0.5 (the reset value of probOccupied)."""
    visited = storage[..., 0, :, :]
    reflected = storage[..., 1, :, :]
    return torch.where(visited > 0.0,
                       reflected / torch.clamp(visited, min=1.0), 0.5)


def apply_update(storage: torch.Tensor, free_only: torch.Tensor,
                 occ_set: torch.Tensor, model: str,
                 log_odds_free: float, log_odds_occupied: float
                 ) -> torch.Tensor:
    """Applies one scan's free/occupied cell sets to a level's storage
    (or R robots' sets to R storages, with a leading robot axis on all
    three). ``free_only`` must already exclude occupied cells (occupied
    wins). Returns a new tensor; ``storage`` is not modified."""
    f32 = storage.dtype
    if model == LOG_ODDS:
        occ_applied = occ_set & (storage < _OCC_CLAMP)
        return (storage
                + torch.where(free_only, float(np.float32(log_odds_free)),
                              0.0).to(f32)
                + torch.where(occ_applied,
                              float(np.float32(log_odds_occupied)),
                              0.0).to(f32))
    if model == SIMPLE_COUNT:
        free_applied = free_only & (storage > float(_SC_FREE_LIMIT))
        occ_applied = occ_set & (storage < float(_SC_OCC_LIMIT))
        return (storage
                + torch.where(free_applied, float(_SC_FREE), 0.0).to(f32)
                + torch.where(occ_applied, float(_SC_OCC), 0.0).to(f32))
    if model == REFLECTANCE:
        visited = storage[..., 0, :, :] + free_only.to(f32) + occ_set.to(f32)
        reflected = storage[..., 1, :, :] + occ_set.to(f32)
        return torch.stack([visited, reflected], dim=-3)
    raise ValueError(f"unknown cell model {model!r}")
