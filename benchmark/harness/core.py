"""What every cell's run shares: the run's context, the card's
description, the check on loaded modules and the result line.

A driver (``benchmark/drivers/<name>.py``) gets a ``Run`` and fills it:
set-up, then the measured window, then the comparison with the
reference. ``result`` turns it into the result line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from typing import Any, Dict, List

from .spec import Cell, metric_reader
from .trace import Tracer

# top-level module names the run's process may not hold, compared whole
# ("hector_slam_tpu_torch" is the program; "hector_slam_tpu" the JAX
# package it was ported from)
FORBIDDEN = ("jax", "jaxlib", "flax", "hector_slam_tpu")


class NoCard(RuntimeError):
    pass


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    tracer: Tracer
    t_process: float                      # perf_counter at process start
    device: str = "cuda"                  # "cpu" only in the CPU tests
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: Dict[str, float] = dataclasses.field(default_factory=dict)
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def traced(self) -> bool:
        return self.tracer.enabled

    def setup_done(self) -> None:
        """Marks the start of the first timed operation."""
        self.e2e["setup_s"] = time.perf_counter() - self.t_process

    def note(self, text: str) -> None:
        self.notes.append(text)
        print(text, file=sys.stderr, flush=True)


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} CUDA devices, "
                     f"{torch.cuda.device_count()} present")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_loaded() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def per_layer(run: Run) -> Dict[str, float]:
    """Each per-layer metric's reader, over what the run recorded; a
    reader that finds nothing returns None and its metric is left out."""
    out = {}
    for entry in run.cell.per_layer:
        value = metric_reader(entry["name"]).read(run)
        if value is not None:
            out[entry["name"]] = float(value)
    return out


def judged(run: Run):
    """(correct, {number: {"value", "limit"}}): every number the cell's
    limits file names, none missing, each at most its limit."""
    limits = run.cell.limits
    checks = {k: {"value": run.checks.get(k), "limit": limits[k]}
              for k in sorted(limits)}
    correct = all(v["value"] is not None and v["value"] <= v["limit"]
                  for v in checks.values())
    return correct, checks


def as_control(run: Run) -> Run:
    """The run with the control's numbers (``run.info["control"]``) in
    the program's place, to be judged as the program is."""
    return dataclasses.replace(run, checks=dict(run.info["control"]))


def result(run: Run, device_count: int) -> Dict[str, Any]:
    import torch
    correct, checks = judged(run)
    if run.traced:
        values = per_layer(run)
        units = {m["name"]: m["unit"] for m in run.cell.per_layer}
    else:
        values = {m["name"]: run.e2e[m["name"]] for m in run.cell.end_to_end}
        units = {m["name"]: m["unit"] for m in run.cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": device_count,
              "memory_peak_bytes": int(run.memory_peak_bytes),
              "nvidia_smi": card_line()}
    line: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in values.items()},
        "device": device}
    trace = run.tracer.trace
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        line["breakdown"] = trace.breakdown()
    line["checks"] = checks
    return line


def emit(line: Dict[str, Any]) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard
    output."""
    print(f"correct = {line['correct']}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
