"""CUDA graphs of the compiled entry points: the counterpart of the JAX
package's ``jax.jit`` cache (``slam_step_jit``, ``run_log_jit``,
``match_hypotheses_jit``, ``fleet_step_jit``, ...).

An entry point hands ``entry`` a body and its tensors in two groups:
  - ``held``: tensors the graph uses where they lie (a donated state's
    map levels and quads, a matcher's map). They are part of the cache
    key (data pointer, shape, strides, dtype), so a graph reads and
    writes the caller's own memory, and two callers with different maps
    never share a graph;
  - ``copied``: tensors copied into the graph's own static buffers before
    a replay (pose leaves, scans, hypotheses), unless the caller passes
    the static buffer itself, as it does with the state a donating step
    returned. Only their shapes and dtypes are keyed.
``body(held, statics, write)`` computes the outputs from them with torch
ops and the port's kernel wrappers; with ``write`` it also writes the
donated state back into ``held`` and ``statics`` (the graph's in-place
update), without it it writes nothing.

A miss warms up, then captures: the body runs once eagerly on a side
stream without writing (it builds the kernels, raises the moments
kernel's shared memory limit, puts the transforms' constants on the card)
and is then captured with writing into a private memory pool. The index
tensors, grids and outputs allocated during the capture are pool memory
that lives as long as the graph, so the pointers the kernels were
launched with stay valid. A failed warm-up or capture raises: nothing
falls back to the eager functions.

Collectives: a body given an NCCL process group (the sharded steps,
parallel/sharded.py) issues its all-reduces inside the capture, and
every replay issues them again. The warm-up issues the same collectives
on the same group first, which creates the communicator outside the
capture. The capture is thread-local: its own thread may make no call
that is unsafe during a capture, while other threads (NCCL's watchdog,
which queries events) go on as before. Every rank must then replay the
same graphs in the same order, as it would issue the eager collectives.

Launch counts: a replay runs no Python, so the kernel wrappers'
``launches`` counters see the capture, not the replays. The capture's
counts are taken back and added again at every replay, so the counters
keep counting launches on the card. The warm-up's launches are real and
stay counted.

At most ``MAX_GRAPHS`` graphs are kept, the least recently used dropped
first (with its pool and its references to held tensors).

Spans and counters (``tracing``): each use of a graph is an
``hs.graph:<entry>`` span holding ``hs.graph.lookup`` (with
``hs.graph.capture`` inside it on a miss), ``hs.graph.replay`` and
``hs.graph.outputs``, and is timed under ``graph.host[<entry>]``; a use
that captured is left out of that time (and of every time around it) and
timed under ``graph.capture``. A replay's host time is summed under
``graph.replay_host``, a graph's first replay left out; the map update
bodies a capture counted (``update.runs``) are taken back and added
again at every replay, as the launches are. ``totals()`` reads them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, NamedTuple, Sequence

import torch

from .. import tracing
from ..ops.interp_moments import interp_moments, interp_moments_level
from ..ops.map_tail import map_tail
from ..ops.paint_cells import paint_cells
from ..ops.raster_paint import raster_paint
from ..ops.robot_match import robot_match_level

MAX_GRAPHS = 8
COUNTED = {"interp_moments": interp_moments,
           "interp_moments_level": interp_moments_level,
           "robot_match_level": robot_match_level,
           "paint_cells": paint_cells, "raster_paint": raster_paint,
           "map_tail": map_tail}


class GraphStats(NamedTuple):
    name: str
    per_replay: Dict[str, int]   # kernel launches of one replay
    warmup: Dict[str, int]       # kernel launches of the warm-up run
    pool_bytes: int              # device memory reserved by the capture
    replays: int


class Entry:
    """One captured graph: its static buffers, outputs and counts."""

    def __init__(self, name, graph, held, statics, outputs, per_replay,
                 warmup, pool_bytes, updates=0):
        self.name = name
        self.graph = graph
        self.held = held          # kept alive: the graph uses their memory
        self.statics = statics
        self.outputs = outputs
        self.per_replay = per_replay
        self.warmup = warmup
        self.pool_bytes = pool_bytes
        self.updates = updates    # map update bodies in one replay
        self.replays = 0

    def copy_in(self, copied: Sequence[torch.Tensor]) -> None:
        for static, src in zip(self.statics, copied):
            if src is not static:
                static.copy_(src)

    def replay(self) -> None:
        with tracing.Timer("graph.replay_host", "hs.graph.replay",
                           timed=self.replays > 0):
            self.graph.replay()
        self.replays += 1
        _TOTALS["replays"] += 1
        for name, n in self.per_replay.items():
            COUNTED[name].launches += n
            _TOTALS["launches"][name] += n
        tracing.count("update.runs", self.updates)

    def stats(self) -> GraphStats:
        return GraphStats(self.name, dict(self.per_replay), dict(self.warmup),
                          self.pool_bytes, self.replays)


_CACHE: "OrderedDict[tuple, Entry]" = OrderedDict()
# since import: graphs captured, replays, and the kernel launches of the
# graphs' warm-ups and replays
_TOTALS = {"captures": 0, "replays": 0,
           "launches": {name: 0 for name in COUNTED}}


def on_card(t: torch.Tensor) -> bool:
    """Whether an entry point given ``t`` replays a graph (a CUDA tensor)
    or runs its body eagerly (a CPU tensor)."""
    return t.device.type == "cuda"


def _counts() -> Dict[str, int]:
    return {name: k.launches for name, k in COUNTED.items()}


def _updates() -> int:
    return tracing.counters().get("update.runs", 0)


def _key(name, static_key, held, copied):
    return (name, static_key,
            tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
                   t.device) for t in held),
            tuple((tuple(t.shape), t.dtype, t.device) for t in copied))


def _capture(name, held, copied, body) -> Entry:
    device = (list(held) + list(copied))[0].device
    statics = [t.clone(memory_format=torch.contiguous_format)
               for t in copied]
    before = _counts()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            body(held, statics, False)
    except Exception as err:
        raise RuntimeError(f"{name}: the warm-up run before the CUDA graph "
                           f"capture failed: {err}") from err
    torch.cuda.current_stream(device).wait_stream(side)
    warmup = {k: n - before[k] for k, n in _counts().items()}
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    before = _counts()
    updates = _updates()
    stream = torch.cuda.current_stream(device)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = body(held, statics, True)
    except Exception as err:
        # a capture that fails as it ends leaves its stream current
        torch.cuda.set_stream(stream)
        raise RuntimeError(f"{name}: CUDA graph capture failed (the body "
                           f"must not read device data on the host): "
                           f"{err}") from err
    finally:
        after = _counts()
        for kname, kernel in COUNTED.items():
            kernel.launches = before[kname]
        updates = _updates() - updates
        tracing.count("update.runs", -updates)
    per_replay = {k: n - before[k] for k, n in after.items()}
    _TOTALS["captures"] += 1
    for kname, n in warmup.items():
        _TOTALS["launches"][kname] += n
    return Entry(name, graph, list(held), statics, outputs, per_replay,
                 warmup, torch.cuda.memory_reserved(device) - reserved,
                 updates)


def entry(name: str, static_key, held: Sequence[torch.Tensor],
          copied: Sequence[torch.Tensor],
          body: Callable[[List[torch.Tensor], List[torch.Tensor], bool],
                         object]) -> Entry:
    """The graph of ``body`` for this static signature and these held
    tensors, captured on the first call, with ``copied`` copied into its
    static buffers. The caller then replays it (``Entry.replay``) and
    reads ``Entry.outputs`` and ``Entry.statics``, which the next replay
    overwrites."""
    with tracing.span("hs.graph.lookup"):
        key = _key(name, static_key, held, copied)
        found = _CACHE.get(key)
        if found is None:
            with tracing.Timer("graph.capture", "hs.graph.capture"):
                found = _capture(name, held, copied, body)
            tracing.captured()
            _CACHE[key] = found
            while len(_CACHE) > MAX_GRAPHS:
                _CACHE.popitem(last=False)
                tracing.count("graph.evictions")
        else:
            _CACHE.move_to_end(key)
        found.copy_in(copied)
    return found


def use(name: str) -> tracing.Timer:
    """The span ``hs.graph:<name>`` and the timer ``graph.host[<name>]``
    of one use of an entry point's graph: lookup, copy-in, replay and
    outputs."""
    return tracing.Timer(f"graph.host[{name}]", f"hs.graph:{name}")


def call(name: str, static_key, held: Sequence[torch.Tensor],
         copied: Sequence[torch.Tensor],
         fn: Callable[[List[torch.Tensor], List[torch.Tensor]], object]):
    """One replay of the graph of ``fn(held, statics)``, a function that
    writes nothing into its inputs, and fresh copies of its outputs."""
    with use(name):
        graph = entry(name, static_key, held, copied,
                      lambda h, statics, write: fn(h, statics))
        graph.replay()
        return fresh(graph.outputs)


def fresh(tree):
    """A copy of every tensor of a (nested) tuple of graph outputs, which
    the graph's next replay would overwrite."""
    with tracing.span("hs.graph.outputs"):
        return _fresh(tree)


def _fresh(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        parts = [_fresh(t) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return tree


def write_back(dst: Sequence[torch.Tensor],
               src: Sequence[torch.Tensor]) -> None:
    """Copies each ``src`` tensor into its ``dst`` (a donated input),
    skipping those that already are it. Sources that are another
    destination are copied aside first, so no write is read later."""
    with tracing.span("hs.graph.outputs"):
        dst, src = list(dst), list(src)
        ids = {id(t) for t in dst}
        src = [s.clone() if s is not d and id(s) in ids else s
               for d, s in zip(dst, src)]
        for d, s in zip(dst, src):
            if s is not d:
                d.copy_(s)


def stats() -> List[GraphStats]:
    """The kept graphs' names, launch counts, pool sizes and replays,
    oldest first."""
    return [e.stats() for e in _CACHE.values()]


def totals() -> dict:
    """Since import, surviving ``clear()``: {"captures", "replays",
    "launches": {kernel: the launches of every graph's warm-up and
    replays}, "evictions", "capture_ns" (host time of the captures),
    "replay_host": [replays, replays timed, host ns of the timed ones]
    (first replays not timed), "entries": {entry point: [uses, uses
    timed, host ns of the timed ones]} (uses that captured not timed)}."""
    c = tracing.counters()
    entries = {name[len("graph.host["):-1]: [c[name], c[name + ".timed"],
                                            c[name + ".ns"]]
               for name in c if name.startswith("graph.host[")
               and name.endswith("]")}
    return {"captures": _TOTALS["captures"], "replays": _TOTALS["replays"],
            "launches": dict(_TOTALS["launches"]),
            "evictions": c.get("graph.evictions", 0),
            "capture_ns": c.get("graph.capture.ns", 0),
            "replay_host": tracing.timed("graph.replay_host"),
            "entries": entries}


def clear() -> None:
    """Drops every kept graph, its pool and its held tensors."""
    _CACHE.clear()
