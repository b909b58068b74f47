"""The fleet cell (``fleet40.tutorial-2048x2-fleet8``) run whole on the CPU
at ``tiny.tiny_cell``'s size, everything but the look for a card: a
sound run comes out correct; the lower-precision control does not; nor
does a run with a fault planted in its timed path, underneath the
harness: ``FleetSession``'s ``fleet_step_jit`` wrapped so that its
answers go wrong in one of the ways a later change could make them.

Faults (``fleet_fault(kind)``): ``unchanged`` (the step returns the
fleet's state as it got it), ``moved`` (one robot's pose moved by
``faults.SHIFT`` where it is made, once), ``unpainted`` (the second half
of the robots' maps left as they were before each step).
"""

import pytest

from benchmark.harness import core
from benchmark.tests import tiny
from benchmark.tools import faults

CELL = "fleet40.tutorial-2048x2-fleet8"
KINDS = ("unchanged", "moved", "unpainted")


def fleet_fault(kind):
    """(module, attribute, broken entry point) of a fleet fault."""
    import hector_slam_tpu_torch.fleet_session as fs
    real = fs.fleet_step_jit
    calls = [0]

    def step(states, scans, cfg):
        r = states.pose.shape[0]
        kept = [lo[r // 2:].clone() for lo in states.log_odds + states.quads]
        new, metrics = real(states, scans, cfg)
        calls[0] += 1
        if kind == "unchanged":
            return states, metrics
        if kind == "moved":
            if calls[0] == 150:   # the last robot's pose, where it is made
                pose = new.pose.clone()
                pose[r - 1, 0] += faults.SHIFT
                new = new._replace(pose=pose)
            return new, metrics
        # "unpainted": the second half of the robots keep the maps they had
        for dst, src in zip(new.log_odds + new.quads, kept):
            dst[r // 2:].copy_(src)
        return new, metrics
    return fs, "fleet_step_jit", step


def test_sound_run_is_correct():
    run = tiny.run_tiny(CELL)
    correct, checks = core.judged(run)
    assert correct, checks
    robots = run.cell.config["robots"]
    assert run.attempted > 0 and run.attempted % robots == 0
    assert run.failed == 0
    assert run.e2e["scan_p95_ms"] > 0


def test_control_is_not_correct():
    run = tiny.run_tiny(CELL, control=True)
    correct, checks = core.judged(core.as_control(run))
    assert not correct, checks


@pytest.mark.parametrize("kind", KINDS)
def test_broken_timed_path_is_not_correct(monkeypatch, kind):
    target, name, broken = fleet_fault(kind)
    monkeypatch.setattr(target, name, broken)
    run = tiny.run_tiny(CELL, seconds=1.0)
    correct, checks = core.judged(run)
    assert not correct, checks
