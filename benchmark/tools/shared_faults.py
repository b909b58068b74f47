"""Faults planted in the shared-map cell's timed path, underneath the
harness, as ``tools/faults.py`` plants them in the other cells: the
program's shared-map step wrapped so that its answers go wrong in one of
the ways a later change could make them. A run with a fault planted has
to come out not correct.

Kinds:
  ``left_out``   one robot's cell sets left out of the union on every
                 tick (the last robot's gate dropped from the paint,
                 while its gate and pose are reported as they are);
  ``unwritten``  one tick whose any-gate fired left unwritten (the first
                 such tick from tick ``AT`` of the run on: the shared
                 map and its quads put back as they were before the
                 step);
  ``moved``      one answer moved by ``faults.SHIFT`` where it is made
                 (the last robot's pose at tick ``AT`` of the run).

Each run of a process that runs many seeds gets its fault.

``register()`` adds them to ``tools/faults.py``'s table under the cell's
mix, so ``tools/calibrate.py --fault <kind>`` plants them:

    python3 benchmark/tools/shared_faults.py --workload <cell> ... \
        [calibrate.py's options]
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

AT = 150
KINDS = ("left_out", "unwritten", "moved")


def shared_fault(kind):
    """(module, attribute, broken callable) of a shared-map fault."""
    if kind == "left_out":
        import hector_slam_tpu_torch.parallel.shared_map as sm
        real_paint = sm.paint_pyramid

        def paint(*args, gates, **kwargs):
            r = gates.shape[0]
            keep = torch.arange(r, device=gates.device) != r - 1
            return real_paint(*args, gates=gates & keep, **kwargs)
        return sm, "paint_pyramid", paint

    import hector_slam_tpu_torch.fleet_session as fs
    from benchmark.tools import faults
    real = fs.shared_fleet_step_jit
    done = [False]

    def step(state, scans, cfg):
        # the run's tick, from 0 in every session: one fault a run, also
        # when one process runs many seeds
        tick = int(state.step)
        if tick == 0:
            done[0] = False
        if kind == "moved":
            new, metrics = real(state, scans, cfg)
            if tick == AT:
                pose = new.pose.clone()
                pose[-1, 0] += faults.SHIFT
                new = new._replace(pose=pose)
            return new, metrics
        armed = tick >= AT and not done[0]
        kept = [t.clone() for t in state.log_odds + state.quads] \
            if armed else []
        new, metrics = real(state, scans, cfg)
        if armed and bool(metrics.map_updated.any()):
            for dst, src in zip(new.log_odds + new.quads, kept):
                dst.copy_(src)
            done[0] = True
        return new, metrics
    return fs, "shared_fleet_step_jit", step


def register() -> None:
    from benchmark.tools import faults
    faults.FAULTS["shared40"] = (shared_fault, KINDS)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from benchmark.tools import calibrate
    register()
    sys.exit(calibrate.main())
