"""Spans and counters at the port's layer boundaries.

Spans: ``span(name)`` is a ``torch.profiler.record_function(name)`` while
a ``torch.profiler`` records, so the span lands in the profiler's trace
beside the card's kernels, on the same clock; otherwise it is a shared
null context, and costs one read of the profiler's flag. Every span name
starts with ``hs.``; a span's parent is the span open around it on the
same host thread:

  hs.scan                  one scan through ``SlamSession``
    hs.convert             ranges or points to a ``Scan`` on the device
    hs.graph:<entry>       one use of a compiled entry point's graph
      hs.graph.lookup      the cache key, the cache and the copy-in
        hs.graph.capture   warm-up and capture, on a miss only
      hs.graph.replay      the host side of ``CUDAGraph.replay``
      hs.graph.outputs     fresh copies of the graph's outputs
    hs.read                the pose, covariance and gate to the host
  hs.fleet                 one tick of a fleet through ``FleetSession``
    hs.fleet.convert       the R robots' ranges to one ``Scan``
    hs.graph:fleet_step_jit (hs.graph:shared_fleet_step_jit, one map)
    hs.fleet.read          the R poses and gates to the host

Counters: plain ints since import, read with ``counters()``. An event
count always counts. A timed counter (``Timer``) adds the host time of
its calls, by ``time.perf_counter_ns``, under ``<name>.ns`` and the
number of calls timed under ``<name>.timed``, so its mean is one over
the other. It leaves out calls made while a profiler records, so a
traced run reads as an untraced one does, and calls around a graph's
capture (``captured``), which is timed under ``graph.capture`` alone.

  session.scan, session.convert, session.read   timed, per scan
  graph.host[<entry>]                           timed, per use of a graph
  graph.capture, graph.replay_host              timed, per capture / replay
  graph.evictions                               graphs the cache dropped
  update.runs                                   map update bodies run
  update.gated                                  scans whose gate fired
  fleet.step, fleet.convert, fleet.read         timed, per fleet tick
  fleet.robot_steps                             robot-scans of the ticks
  fleet.gated                                   robot-scans whose gate fired
  fleet.map_writes                              shared-map ticks that wrote it
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from time import perf_counter_ns
from typing import Dict, List

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, int] = defaultdict(int)
_TIMED: Dict[str, List[int]] = {}   # name -> [calls, calls timed, ns]
_CAPTURES = 0                       # graphs captured since import


def span(name: str):
    """A profiler span named ``name`` while a profiler records, else a
    null context that creates nothing."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] += n


def captured() -> None:
    """Marks a graph's capture: every timer open around it leaves its
    call untimed."""
    global _CAPTURES
    _CAPTURES += 1


class Timer:
    """A span and a timed counter around one call:

        with tracing.Timer("session.read", "hs.read") as t:
            ...

    ``t.t0`` and ``t.t1`` are its clock readings (``perf_counter_ns``),
    taken whether or not a profiler records. ``timed=False`` leaves the
    call's time out of the counter."""

    __slots__ = ("name", "timed", "t0", "t1", "_span", "_captures")

    def __init__(self, name: str, span_name: str, timed: bool = True):
        self.name = name
        self.timed = timed
        self._span = None
        if _profiler._is_profiler_enabled:
            self.timed = False
            self._span = torch.profiler.record_function(span_name)

    def __enter__(self) -> "Timer":
        if self._span is not None:
            self._span.__enter__()
        self._captures = _CAPTURES
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = t1 = perf_counter_ns()
        c = _TIMED.get(self.name)
        if c is None:
            c = _TIMED[self.name] = [0, 0, 0]
        c[0] += 1
        if self.timed and self._captures == _CAPTURES:
            c[1] += 1
            c[2] += t1 - self.t0
        if self._span is not None:
            self._span.__exit__(*exc)


def timed(name: str) -> List[int]:
    """[calls, calls timed, host ns of the timed calls] of one timed
    counter since import."""
    return list(_TIMED.get(name, (0, 0, 0)))


def counters() -> Dict[str, int]:
    """A snapshot of every counter since import: event counts by name,
    and for each timed counter ``<name>`` (calls), ``<name>.timed`` and
    ``<name>.ns``."""
    out = dict(_COUNTS)
    for name, (calls, n, ns) in _TIMED.items():
        out[name] = calls
        out[name + ".timed"] = n
        out[name + ".ns"] = ns
    return out
