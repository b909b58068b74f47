"""Checkpoint/resume: the whole SLAM state is one NamedTuple, so a
checkpoint is its leaves in an npz. The reference has no checkpointing
at all (SURVEY.md §5: only reset and export artifacts).

Counterpart of ``hector_slam_tpu/io/checkpoint.py``, file for file: the
leaves are written in the order ``jax.tree.flatten`` gives the JAX
package's slim state (``quads`` dropped; they are derived data, 4x the
map, recomputed on load): every log-odds level, then pose,
last_map_update_pose, covariance, step, map_update_count, as
``leaf_0 ... leaf_k``, beside ``num_levels``. The port's ``SlamState``
has the JAX state's field order, so a checkpoint written by either
package loads in the other. The JAX package's orbax pair has no torch
counterpart.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..core.slam import init_state, quads_of
from ..types import SlamState, host_array, resolve_device


def checkpoint_leaves(state: SlamState) -> List:
    """The leaves a checkpoint holds, in its order: the state without its
    quads, as ``jax.tree.flatten`` orders the JAX package's."""
    return [*state.log_odds, state.pose, state.last_map_update_pose,
            state.covariance, state.step, state.map_update_count]


def save_state(path: str, state: SlamState) -> None:
    """Writes ``state`` (one robot, a per-robot fleet or a shared fleet;
    its tensors on any device) to the npz ``path``."""
    arrays = {f"leaf_{i}": host_array(leaf)
              for i, leaf in enumerate(checkpoint_leaves(state))}
    arrays["num_levels"] = np.asarray(len(state.log_odds))
    np.savez_compressed(path, **arrays)


def load_state(path: str, cfg: SlamConfig,
               template: Optional[SlamState] = None,
               device="cuda") -> SlamState:
    """The state in the npz ``path``, on ``device`` (the card unless the
    caller asks for the CPU), its quads recomputed. ``template``: the
    expected state structure, whose leaf shapes the checkpoint must have —
    by default a fresh single-robot ``init_state(cfg)``; pass
    ``init_fleet(cfg, R)`` or ``init_shared_fleet(cfg, R)`` to restore a
    fleet (their pose/covariance leaves carry a leading robot axis).
    Raises ValueError when the level count or a leaf's shape differs."""
    dev = resolve_device(device)
    if template is None:
        template = init_state(cfg, device="cpu")
    want = checkpoint_leaves(template)
    with np.load(path) as z:
        n = int(z["num_levels"])
        if n != cfg.map.levels:
            raise ValueError(f"checkpoint has {n} pyramid levels, config "
                             f"wants {cfg.map.levels}")
        arrays = [z[f"leaf_{i}"] for i in range(len(want))]
    for got, leaf in zip(arrays, want):
        if got.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf shape {got.shape} != config "
                             f"{tuple(leaf.shape)}")
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    log_odds = tuple(t[:n])
    pose, last_update, cov, step, count = t[n:]
    return SlamState(log_odds=log_odds, pose=pose,
                     last_map_update_pose=last_update, covariance=cov,
                     step=step, map_update_count=count,
                     quads=quads_of(log_odds, cfg.update.cell_model))
