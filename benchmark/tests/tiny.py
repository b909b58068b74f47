"""The benchmark's cells cut to a size a CPU test holds: a 256 x 256 map
at 0.1 m, 181 beams, 120-scan laps, 64 hypotheses. The
drivers, the reference and the limits are the cells' own."""

from __future__ import annotations

import copy
import importlib
import time

from benchmark.harness import core, spec, trace

CELLS = ("live40.tutorial-2048x2", "reloc4096.tutorial-2048x2")


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["map"].update(resolution=0.1, size_x=256, size_y=256, levels=2)
    cfg["laser"].update(num_beams=181, angle_increment=0.02618)
    cfg["max_beams"] = 192
    cfg["max_ray_cells"] = 128
    tr = copy.deepcopy(cell.traffic)
    tr["lap_scans"] = 120
    if "hypotheses" in tr:
        tr.update(hypotheses=64, batches=8, checked_calls=4)
    cell.config, cell.traffic = cfg, tr
    return cell


def run_tiny(name: str, seed: int = 2 ** 31 + 7, seconds: float = 0.5,
             control: bool = False) -> core.Run:
    """One run of the cut cell on the CPU, everything but the look for a
    card: set-up, window and the judgement."""
    cell = tiny_cell(name)
    run = core.Run(cell, seed, seconds, trace.Tracer(False),
                   time.perf_counter(), device="cpu")
    run.info["with_control"] = control
    importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}").main(run)
    return run
