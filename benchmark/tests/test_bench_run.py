"""A whole run on the CPU at a test's size, everything but the look for a
card: sound runs come out correct; the lower-precision control and a
timed path broken underneath do not. And the entry point itself: no
card, no result; no JAX in its process."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import core, spec
from benchmark.tests import tiny
from benchmark.tools import faults

ROOT = spec.ROOT


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell):
    run = tiny.run_tiny(cell)
    correct, checks = core.judged(run)
    assert correct, checks
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct(cell):
    run = tiny.run_tiny(cell, control=True)
    correct, checks = core.judged(core.as_control(run))
    assert not correct, checks


FAULTS = [(cell, kind) for cell in tiny.CELLS
          for kind in faults.FAULTS[cell.split(".")[0]][1]]


@pytest.mark.parametrize("cell,kind", FAULTS,
                         ids=[f"{c.split('.')[0]}-{k}" for c, k in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, kind):
    target, name, broken = faults.wrapper(cell, kind)
    monkeypatch.setattr(target, name, broken)
    run = tiny.run_tiny(cell, seconds=1.0)
    correct, checks = core.judged(run)
    assert not correct, checks


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "live40.tutorial-2048x2", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "CUDA" in p.stderr


CHECK = """
import sys
sys.path.insert(0, {root!r})
{body}
top = {{m.split('.')[0] for m in sys.modules}}
print(sorted(top & {{'jax', 'jaxlib', 'flax', 'hector_slam_tpu',
                    'hector_slam_tpu_torch'}}))
"""


def _loaded(body):
    p = subprocess.run([sys.executable, "-c",
                        CHECK.format(root=str(ROOT), body=body)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"'))


def test_harness_loads_no_jax():
    body = """
import glob, os
from benchmark.run import prepare
prepare()
from benchmark.harness import spec
from benchmark.tools import calibrate, runs
from benchmark.tests import tiny
for m in glob.glob(os.path.join(str(spec.BENCH), 'metrics', '*.py')):
    spec.metric_reader(os.path.basename(m)[:-3])
for c in tiny.CELLS:
    tiny.run_tiny(c, seconds=0.2)
"""
    assert _loaded(body) == ["hector_slam_tpu_torch"]


def test_reference_loads_nothing_of_the_program():
    body = """
from benchmark.reference import judge, slam_ref
from benchmark.roofline import formulas
from benchmark.sim import traffic, world
"""
    assert _loaded(body) == []
