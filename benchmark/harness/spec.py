"""A cell's files, found by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration and traffic mix and the metrics; each
of them is a file of its own under ``benchmark/``:

  configs/<config>.json     the deployment: SlamConfig fields, laser,
                            robots, chips, source, assumed, reduced
  traffic/<traffic>.json    the mix's parameters and the driver that
                            runs its window (``drivers/<driver>.py``)
  limits/<cell>.json        the limit of each number ``correct`` compares
  metrics/<name>.py         a per-layer metric's reader

A later cell, mix or metric is a new file and a new entry; no file here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]     # the spec's entries that this cell reports
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "benchmark"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reported(m, name)])


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "benchmark" / "metrics" / f"{name}.py",
                       "benchmark_metric_" + re.sub(r"\W", "_", name))
