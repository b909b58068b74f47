"""Writes the JAX session reference that the PyTorch port's ``SlamSession``
is held against on the card, where JAX is not installed.

Scenario (``chip_smoke.py``'s ``session`` phase replays the same):
  1. the JAX ``SlamSession`` on ``BENCH_CONFIG`` (1024^2 @ 0.05 m, 3
     levels) replays the committed corridor fixture
     (tests/fixtures/corridor_utm30lx.npz, 435 scans of 1081 beams, the
     fixture's own ``LaserModel``) through ``process_ranges`` with stamps
     t x 0.025 s;
  2. kidnap: the believed pose is shifted by (+0.6 m, -0.5 m, +0.25 rad);
  3. ``relocalize(n_hypotheses=1024, sigma_xy=0.6, sigma_theta=0.3,
     seed=3, method="quad")`` from the kidnapped state;
  4. ``relocalize_global(method="quad")`` with its defaults (2,048
     positions x 32 headings, top 1,024) from the same kidnapped state.

Saved to tests/fixtures/session_jax_reference.npz (a few KB, no map): the
replay's poses f32[435, 3] and update count, the pose before the kidnap,
the shift, and each recovery's pose, residual and ``accepted`` (and the
global call's ``n_free_cells`` and ``sweep_best_residual``).

    JAX_PLATFORMS=cpu python tools/make_torch_session_reference.py

On a CPU this runs for about 25 s and peaks near 0.9 GB of resident
memory (the global sweep scores 65,536 poses).
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "corridor_utm30lx.npz")
REFERENCE = os.path.join(REPO, "tests", "fixtures",
                         "session_jax_reference.npz")
STAMP_S = 0.025
KIDNAP = np.asarray([0.6, -0.5, 0.25], np.float32)
RELOCALIZE = dict(n_hypotheses=1024, sigma_xy=0.6, sigma_theta=0.3, seed=3)


def jax_session_reference(fixture: str = FIXTURE) -> dict:
    """The scenario above through the JAX package, as numpy arrays."""
    import jax.numpy as jnp
    from hector_slam_tpu.config import BENCH_CONFIG
    from hector_slam_tpu.io.scanlog import load_log
    from hector_slam_tpu.session import SlamSession
    ranges, laser, _ = load_log(fixture)
    sess = SlamSession(BENCH_CONFIG, laser)
    poses = np.stack([sess.process_ranges(r, stamp=t * STAMP_S)
                      for t, r in enumerate(ranges)]).astype(np.float32)
    good = sess.pose.copy()
    kidnapped = sess.state._replace(pose=jnp.asarray(good + KIDNAP))
    sess.state = kidnapped
    local = sess.relocalize(method="quad", **RELOCALIZE)
    sess.state = kidnapped
    glob = sess.relocalize_global(method="quad")
    return dict(
        poses=poses, map_update_count=np.int32(sess.state.map_update_count),
        good_pose=good, kidnap=KIDNAP,
        relocalize_pose=np.asarray(local["pose"], np.float32),
        relocalize_residual=np.float32(local["residual"]),
        relocalize_accepted=np.bool_(local["accepted"]),
        global_pose=np.asarray(glob["pose"], np.float32),
        global_residual=np.float32(glob["residual"]),
        global_accepted=np.bool_(glob["accepted"]),
        global_n_free_cells=np.int32(glob["n_free_cells"]),
        global_sweep_best_residual=np.float32(glob["sweep_best_residual"]))


def main() -> None:
    sys.path.insert(0, REPO)
    ref = jax_session_reference()
    np.savez_compressed(REFERENCE, **ref)
    print(f"wrote {REFERENCE}: {len(ref['poses'])} poses, "
          f"{int(ref['map_update_count'])} map updates; relocalize "
          f"accepted={bool(ref['relocalize_accepted'])} "
          f"pose={ref['relocalize_pose']}; global "
          f"accepted={bool(ref['global_accepted'])} "
          f"pose={ref['global_pose']} "
          f"n_free_cells={int(ref['global_n_free_cells'])}; "
          f"good pose {ref['good_pose']}")


if __name__ == "__main__":
    main()
