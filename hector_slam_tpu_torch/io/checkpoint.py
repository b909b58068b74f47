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
package loads in the other.

The JAX package's directory checkpoints (``save_state_orbax`` /
``load_state_orbax``) have their counterpart in ``save_state_dcp`` /
``load_state_dcp``: the same slim leaves, ``leaf_0 ... leaf_k``, written
to a directory by ``torch.distributed.checkpoint`` in one process with no
process group. The two directory formats are not shared (orbax needs
JAX); npz is the format both packages load.
"""

from __future__ import annotations

import os
import warnings
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


def _check_levels(n_levels: int, cfg: SlamConfig) -> None:
    if n_levels != cfg.map.levels:
        raise ValueError(f"checkpoint has {n_levels} pyramid levels, config "
                         f"wants {cfg.map.levels}")


def _check_shapes(shapes, want: List) -> None:
    for got, leaf in zip(shapes, want):
        if tuple(got) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf shape {tuple(got)} != config "
                             f"{tuple(leaf.shape)}")


def _from_leaves(leaves, n: int, cfg: SlamConfig, dev) -> SlamState:
    t = [leaf.to(dev) for leaf in leaves]
    log_odds = tuple(t[:n])
    pose, last_update, cov, step, count = t[n:]
    return SlamState(log_odds=log_odds, pose=pose,
                     last_map_update_pose=last_update, covariance=cov,
                     step=step, map_update_count=count,
                     quads=quads_of(log_odds, cfg.update.cell_model))


def save_state_dcp(path: str, state: SlamState) -> bool:
    """Writes ``state``'s slim leaves to the directory ``path`` with
    ``torch.distributed.checkpoint`` (one process, no process group).
    Returns False, writing nothing, when torch has no distributed
    support, as the JAX package's orbax saver does without orbax."""
    if not torch.distributed.is_available():
        return False
    import torch.distributed.checkpoint as dcp
    leaves = {f"leaf_{i}": leaf.detach().cpu().contiguous()
              for i, leaf in enumerate(checkpoint_leaves(state))}
    with warnings.catch_warnings():   # one process is what is meant
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        dcp.save(leaves, checkpoint_id=os.path.abspath(path), no_dist=True)
    return True


def load_state_dcp(path: str, cfg: SlamConfig,
                   device="cuda") -> Optional[SlamState]:
    """The single-robot state in the directory checkpoint ``path``, on
    ``device`` (the card unless the caller asks for the CPU), its quads
    recomputed; None when torch has no distributed support. Raises
    ValueError when the level count or a leaf's shape differs from
    ``init_state(cfg)``'s."""
    dev = resolve_device(device)
    if not torch.distributed.is_available():
        return None
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    n_leaves = sum(1 for k in meta if k.startswith("leaf_"))
    # the leaves after the levels: pose, last update pose, covariance,
    # step, update count
    _check_levels(n_leaves - 5, cfg)
    want = checkpoint_leaves(init_state(cfg, device="cpu"))
    _check_shapes([meta[f"leaf_{i}"].size for i in range(n_leaves)], want)
    leaves = {f"leaf_{i}": leaf.clone() for i, leaf in enumerate(want)}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        dcp.load(leaves, checkpoint_id=path, no_dist=True)
    return _from_leaves([leaves[f"leaf_{i}"] for i in range(n_leaves)],
                        cfg.map.levels, cfg, dev)


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
        _check_levels(n, cfg)
        arrays = [z[f"leaf_{i}"] for i in range(len(want))]
    _check_shapes([a.shape for a in arrays], want)
    return _from_leaves([torch.from_numpy(a) for a in arrays], n, cfg, dev)
