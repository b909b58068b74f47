"""The traced piece of a ``--trace 1`` run: ``torch.profiler`` with CUDA
activity over a short steady piece of the window, and the benchmark's own
spans (``record_function``) around each call into the program and around
the harness's waits and copies.

The profiler's trace is exported to one temporary file, read into memory
and deleted at once. From it the harness keeps the device's operations
(kernels, copies, fills) and the host spans, and reduces them: the union
of device activity (busy time, with no overlap counted twice), the idle
gaps, each named by the innermost benchmark span open on the host at the
time, and the operations that took most time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW = "bench.traced_window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
SPAN_CATS = {"user_annotation"}


@dataclasses.dataclass
class Trace:
    """Times in microseconds on the trace's clock."""

    start: float
    end: float
    device: List[Tuple[str, float, float, str]]   # (name, ts, dur, cat)
    spans: List[Tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def merged(self, lo: Optional[float] = None, hi: Optional[float] = None):
        """The union of device activity within [lo, hi] as merged
        intervals."""
        lo = self.start if lo is None else lo
        hi = self.end if hi is None else hi
        iv = sorted((max(ts, lo), min(ts + d, hi))
                    for _, ts, d, _ in self.device if ts + d > lo and ts < hi)
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self, lo=None, hi=None) -> float:
        return sum(b - a for a, b in self.merged(lo, hi)) * 1e-6

    def kernels(self) -> int:
        """Kernel launches on the device (copies and fills not counted)."""
        return sum(1 for row in self.device if row[3] == "kernel")

    def kernel_s(self, name: str) -> float:
        """Summed time of the kernels whose name holds ``name``."""
        return sum(d for n, _, d, c in self.device
                   if c == "kernel" and name in n) * 1e-6

    def spans_named(self, name: str):
        return [(ts, d) for n, ts, d in self.spans if n == name]

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals (start, length) of the device in the window."""
        out, t = [], self.start
        for a, b in self.merged():
            if a > t:
                out.append((t, a - t))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end - t))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops: Dict[str, float] = {}
        for n, _, d, _ in self.device:
            ops[n] = ops.get(n, 0.0) + d * 1e-6
        gaps = self.gaps()
        idle: Dict[str, float] = {}
        if gaps:
            names = [n for n, _, _ in self.spans if n != WINDOW]
            starts = np.array([ts for n, ts, _ in self.spans if n != WINDOW])
            durs = np.array([d for n, _, d in self.spans if n != WINDOW])
            for g0, g in gaps:
                mid = g0 + g / 2
                label = "harness"
                if len(names):
                    inside = (starts <= mid) & (starts + durs >= mid)
                    if inside.any():
                        k = np.flatnonzero(inside)
                        label = names[k[np.argmin(durs[k])]]
                idle[label] = idle.get(label, 0.0) + g * 1e-6
        return {"device_ops": sorted(([n[:200], s] for n, s in ops.items()),
                                     key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                    key=lambda x: -x[1])[:top]}


def parse(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        row = (str(e.get("name", "")), float(e["ts"]), float(e.get("dur", 0)))
        if cat in DEVICE_CATS:
            device.append(row + (cat,))
        elif cat in SPAN_CATS:
            spans.append(row)
    windows = [(ts, d) for n, ts, d in spans if n == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no traced window span")
    ts, d = windows[0]
    device = [r for r in device if r[1] + r[2] > ts and r[1] < ts + d]
    return Trace(ts, ts + d, device, spans)


class Tracer:
    """Spans and the profiled piece; does nothing unless enabled."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Optional[Trace] = None
        self._prof = None
        self._window = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def _profiler(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """Starts and stops the profiler once, in set-up, so its own
        start-up is not in the window."""
        if self.enabled:
            import torch
            with self._profiler():
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        import torch
        torch.cuda.synchronize()
        self._prof = self._profiler()
        self._prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        if self._window is None:
            return
        import torch
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.trace = parse(path)
        finally:
            os.unlink(path)
        self._window = None
