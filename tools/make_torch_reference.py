"""Writes the JAX reference trajectory that the PyTorch port is held
against on the card, where JAX is not installed.

Replays the committed corridor fixture (tests/fixtures/corridor_utm30lx.npz,
435 scans of 1081 beams) through the JAX engine's ``run_log_jit`` on
``BENCH_CONFIG`` (1024^2 @ 0.05 m, 3 levels) and saves the poses
f32[435, 3], the gate decisions bool[435] and the map-update count to
tests/fixtures/corridor_jax_reference.npz. ``chip_smoke.py`` replays the
same log through the port and compares. tests/test_torch_slam.py
regenerates the reference and checks it equals the committed file.

    JAX_PLATFORMS=cpu python tools/make_torch_reference.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "corridor_utm30lx.npz")
REFERENCE = os.path.join(REPO, "tests", "fixtures",
                         "corridor_jax_reference.npz")


def jax_reference(fixture: str = FIXTURE) -> dict:
    """The JAX replay of ``fixture`` on BENCH_CONFIG, as numpy arrays."""
    from hector_slam_tpu.config import BENCH_CONFIG
    from hector_slam_tpu.core.slam import init_state, run_log_jit
    from hector_slam_tpu.io.scanlog import (load_log, scan_from_ranges,
                                            stack_scans)
    ranges, laser, _ = load_log(fixture)
    cfg = BENCH_CONFIG
    scans = stack_scans([scan_from_ranges(r, cfg.map.level_scale(0), laser,
                                          cfg.max_beams) for r in ranges])
    state, poses, metrics = run_log_jit(init_state(cfg), scans, cfg)
    return dict(poses=np.asarray(poses, np.float32),
                map_updated=np.asarray(metrics.map_updated, bool),
                map_update_count=np.int32(state.map_update_count))


def main() -> None:
    sys.path.insert(0, REPO)
    ref = jax_reference()
    np.savez_compressed(REFERENCE, **ref)
    print(f"wrote {REFERENCE}: {len(ref['poses'])} poses, "
          f"{int(ref['map_update_count'])} map updates")


if __name__ == "__main__":
    main()
