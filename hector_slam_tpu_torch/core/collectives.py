"""The collectives of the sharded steps, over a ``torch.distributed``
process group: the JAX package's ``psum`` over a mesh axis
(``parallel/sharded.py``). ``group=None`` is no axis (unsharded): each
function then returns its input.

Every call is an all-reduce, the one collective both backends take on
CUDA tensors (gloo also on CPU tensors). The reduced values are equal on
every rank of the group: each element is reduced once and the result
copied to every rank, so a decision taken from them (a gate, a GN step)
is the same on every rank.

An NCCL all-reduce is a kernel on the card's streams, so a CUDA graph
can hold it (``captures_collectives``); gloo reduces a CUDA tensor in
host memory, which no graph can capture.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def captures_collectives(group) -> bool:
    """Whether a CUDA graph can hold this group's collectives on CUDA
    tensors: its backend for them is NCCL (``dist.get_backend``: "nccl",
    or "cuda:nccl" in a per-device list)."""
    return "nccl" in dist.get_backend(group)


def single_rank(group) -> bool:
    """Whether ``group`` reduces nothing: no axis, or a group of one rank
    (whose all-reduce returns its input)."""
    return group is None or dist.get_world_size(group) == 1


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum of ``t`` over the ranks of ``group``, in a new
    tensor."""
    if group is None:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def por(sets: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each bool tensor OR-combined over the ranks of ``group``: all of
    them in one all-reduce (MAX over their bytes)."""
    if group is None:
        return list(sets)
    flat = torch.cat([s.reshape(-1) for s in sets]).view(torch.uint8)
    dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=group)
    parts = flat.view(torch.bool).split([s.numel() for s in sets])
    return [p.reshape(s.shape) for p, s in zip(parts, sets)]
