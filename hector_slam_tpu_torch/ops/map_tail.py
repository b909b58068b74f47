"""The map update's dense tail, in place: the CUDA kernel pair
``csrc/map_tail.cu`` and its plain PyTorch version.

``map_tail`` applies one update's painted cell sets (``_paint_pairs``' raw
free and occupied grids, occupied winning) to every level's storage and
packs the level's quads anew (``quad_pack`` of ``prob_grid``), writing
into the tensors it is given and only for the maps whose gate fired; the
other maps' levels and quads keep their bits and their memory. One gate
serves every map (one robot's scalar gate, a shared map's any-gate), or a
gate per map (a fleet's ``bool[R]``). The chain it replaces, per level:
``apply_update``, ``torch.where(gate, new, old)`` and ``quad_pack``.

It replaces no TPU kernel (the JAX package leaves the chain to XLA); see
the kernel source for why it exists and its design. The wrapper launches
the kernel pair for CUDA tensors (two launches an update, each for every
level) and runs ``map_tail_plain`` only for CPU tensors; there is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import cell_models as cm
from ..core.interp import quad_pack_storage
from . import cuda_build

MAX_LEVELS = 8      # levels of one update (kMaxLevels in the kernel)
MAX_MAPS = 65535    # maps per launch (the grid's y)
_MODELS = {cm.LOG_ODDS: 0, cm.SIMPLE_COUNT: 1, cm.REFLECTANCE: 2}

Sets = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _per_map(gate: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The gate (one, or one a map on ``t``'s first axis) broadcast over
    ``t``."""
    return gate.reshape((-1,) + (1,) * (t.dim() - 1))


def map_tail_plain(levels: Sequence[torch.Tensor],
                   quads: Sequence[torch.Tensor], sets: Sets,
                   gate: torch.Tensor, model: str, log_odds_free: float,
                   log_odds_occupied: float) -> None:
    """The kernels' function in torch ops, written into ``levels`` and
    ``quads``: ``apply_update``, the gate's ``where`` and the quads of the
    chosen storage, for the gated maps."""
    for lv, q, (free_set, occ_set) in zip(levels, quads, sets):
        new = cm.apply_update(lv, free_set & ~occ_set, occ_set, model,
                              log_odds_free, log_odds_occupied)
        lv.copy_(torch.where(_per_map(gate, lv), new, lv))
        q.copy_(torch.where(_per_map(gate, q), quad_pack_storage(lv, model),
                            q))


def _lead(storage: torch.Tensor, model: str) -> int:
    """Map axes in front of a storage's (channels,) height, width: 0 for
    one map, 1 for a robot axis."""
    return storage.dim() - 2 - (model == cm.REFLECTANCE)


def _check(levels, quads, sets, gate, model) -> int:
    """Raises on what the kernels do not take; returns the number of maps
    of each level."""
    if model not in _MODELS:
        raise ValueError(f"map_tail: cell model {model!r} has no map update "
                         f"(one of {sorted(_MODELS)})")
    if not levels or not len(levels) == len(quads) == len(sets):
        raise ValueError(f"map_tail: {len(levels)} levels, {len(quads)} "
                         f"quads, {len(sets)} cell set pairs")
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"map_tail: {len(levels)} levels, at most "
                         f"{MAX_LEVELS}")
    dev = levels[0].device
    channels = 2 if model == cm.REFLECTANCE else 1
    maps = None
    for k, (lv, q, (free_set, occ_set)) in enumerate(zip(levels, quads,
                                                         sets)):
        lead = _lead(lv, model)
        if lead not in (0, 1) or (channels == 2 and lv.shape[-3] != 2):
            raise ValueError(f"map_tail: level {k} storage has shape "
                             f"{tuple(lv.shape)}, expected ([R,] "
                             f"{'2, ' if channels == 2 else ''}H, W)")
        n = lv.shape[0] if lead else 1
        if maps is None:
            maps = n
        h, w = lv.shape[-2:]
        lead_shape = tuple(lv.shape[:lead])
        for name, t, dtype, want in (
                ("storage", lv, torch.float32, tuple(lv.shape)),
                ("quads", q, torch.float32, lead_shape + (h * w, 4)),
                ("free set", free_set, torch.bool, lead_shape + (h, w)),
                ("occupied set", occ_set, torch.bool, lead_shape + (h, w))):
            if t.device != dev:
                raise ValueError(f"map_tail: level {k} {name} is on "
                                 f"{t.device}, storage on {dev}")
            if t.dtype != dtype:
                raise TypeError(f"map_tail: level {k} {name} must be "
                                f"{dtype}, got {t.dtype}")
            if tuple(t.shape) != want:
                raise ValueError(f"map_tail: level {k} {name} has shape "
                                 f"{tuple(t.shape)}, expected {want}")
            if not t.is_contiguous():
                raise ValueError(f"map_tail: level {k} {name} must be "
                                 "contiguous")
        if n != maps:
            raise ValueError(f"map_tail: level {k} holds {n} maps, level 0 "
                             f"{maps}")
    if maps > MAX_MAPS:
        raise ValueError(f"map_tail: {maps} maps, at most {MAX_MAPS}")
    if gate.device != dev:
        raise ValueError(f"map_tail: the gate is on {gate.device}, storage "
                         f"on {dev}")
    if gate.dtype != torch.bool:
        raise TypeError(f"map_tail: the gate must be torch.bool, got "
                        f"{gate.dtype}")
    if gate.numel() != 1 and tuple(gate.shape) != (maps,):
        raise ValueError(f"map_tail: gate of shape {tuple(gate.shape)} for "
                         f"{maps} maps: one gate, or one a map")
    if not gate.is_contiguous():
        raise ValueError("map_tail: the gate must be contiguous")
    return maps


def _library():
    lib = cuda_build.load("map_tail")
    fn = lib.hs_map_tail
    if fn.argtypes is None:
        p = ctypes.c_void_p
        f = ctypes.c_float
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p,
                       p, p, ctypes.c_int, p, ctypes.c_longlong, f, f, f, f,
                       p]
        fn.restype = ctypes.c_int
    return fn


def _constants(model: str, log_odds_free: float,
               log_odds_occupied: float) -> Tuple[float, ...]:
    """(free add, occupied add, free limit, occupied limit) of
    ``apply_update``'s cell model, as f32 values."""
    if model == cm.LOG_ODDS:
        return (float(np.float32(log_odds_free)),
                float(np.float32(log_odds_occupied)), 0.0, cm._OCC_CLAMP)
    if model == cm.SIMPLE_COUNT:
        return (float(cm._SC_FREE), float(cm._SC_OCC),
                float(cm._SC_FREE_LIMIT), float(cm._SC_OCC_LIMIT))
    return (1.0, 1.0, 0.0, 0.0)


def _launch(levels, quads, sets, gate, model, maps, consts) -> None:
    """Both passes, one launch each for every level, on the current
    stream; counted in ``map_tail.launches``. Raises if a launch is
    refused."""
    for q in quads:
        if q.data_ptr() % 16:
            raise ValueError("map_tail: quads must start at a 16-byte "
                             "aligned address")
    fn = _library()
    k_n = len(levels)

    def ptrs(ts):
        return (ctypes.c_void_p * k_n)(*[t.data_ptr() for t in ts])

    args = (k_n, ptrs(levels), ptrs(quads), ptrs([s[0] for s in sets]),
            ptrs([s[1] for s in sets]),
            (ctypes.c_int * k_n)(*[lv.shape[-2] for lv in levels]),
            (ctypes.c_int * k_n)(*[lv.shape[-1] for lv in levels]),
            maps, gate.data_ptr(), 0 if gate.numel() == 1 else 1, *consts)
    with torch.cuda.device(gate.device):
        stream = torch.cuda.current_stream().cuda_stream
        for step in (0, 1):
            rc = fn(step, _MODELS[model], *args, stream)
            if rc != 0:
                raise RuntimeError(f"map_tail: kernel launch failed with "
                                   f"CUDA error {rc}")
            map_tail.launches += 1


def map_tail(levels: Sequence[torch.Tensor], quads: Sequence[torch.Tensor],
             sets: Sets, gate: torch.Tensor, model: str,
             log_odds_free: float, log_odds_occupied: float) -> None:
    """Writes one update into ``levels`` (f32 storage per level, ``[R,]
    [2,] H, W``) and ``quads`` (f32 ``[R,] H*W, 4``) in place, for the
    maps whose ``gate`` (bool: one, or ``[R]``) is set: ``sets`` holds each
    level's painted (free, occupied) bool grids (``[R,] H, W``). Every
    tensor contiguous and on one device. CPU tensors take the plain
    version; CUDA tensors launch the kernel pair (on the current stream)
    or raise."""
    maps = _check(levels, quads, sets, gate, model)
    if levels[0].device.type == "cpu":
        map_tail_plain(levels, quads, sets, gate, model, log_odds_free,
                       log_odds_occupied)
        return
    _launch(levels, quads, sets, gate, model, maps,
            _constants(model, log_odds_free, log_odds_occupied))


map_tail.launches = 0   # kernel launches, two an update (core/graphs.py)
