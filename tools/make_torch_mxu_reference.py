"""Writes the JAX reference that the PyTorch port's "mxu" recovery
(``SlamSession.relocalize(method="mxu")``, the theta-bucketed patch
matcher) is held against on the card, where JAX is not installed.

Scenario (``chip_smoke.py``'s ``session`` phase and
tests/test_torch_recovery_graphs.py replay the same):
  1. the JAX session's state after the 435-scan corridor replay on
     ``BENCH_CONFIG`` and its last scan: the JAX checkpoint in
     tests/fixtures/queries_jax_reference.npz;
  2. kidnap: the pose is shifted by (+0.6 m, -0.5 m, +0.25 rad);
  3. ``relocalize(n_hypotheses=n, sigma_xy=0.6, sigma_theta=0.3, seed=3,
     method="mxu")`` from the kidnapped state, for n = 256 (no pruning)
     and n = 1024 (pruned to 256).

Saved to tests/fixtures/mxu_jax_reference.npz (a few KB, no map), for
each n (keys suffixed ``_<n>``): the batch the matcher refined
(``refine_hyp``), the session's result (pose, residual, accepted,
fast_path_fraction, overflow_steps, all from JAX's compiled
``match_hypotheses_mxu_jit``), and the diag of JAX's op-by-op
``match_hypotheses_mxu`` on the same batch (``eager_diag``: repaired,
overflow steps, total and slow queries), since a compiled XLA program
sums a Hessian in another order than its op-by-op run and an
ill-conditioned hypothesis can carry that into a patch decision.

    JAX_PLATFORMS=cpu python tools/make_torch_mxu_reference.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE = os.path.join(REPO, "tests", "fixtures", "queries_jax_reference.npz")
REFERENCE = os.path.join(REPO, "tests", "fixtures", "mxu_jax_reference.npz")
KIDNAP = np.asarray([0.6, -0.5, 0.25], np.float32)
RELOCALIZE = dict(sigma_xy=0.6, sigma_theta=0.3, seed=3, method="mxu")
SIZES = (256, 1024)


def jax_mxu_reference(state_path: str = STATE) -> dict:
    """The scenario above through the JAX package, as numpy arrays."""
    import jax.numpy as jnp
    from hector_slam_tpu.config import BENCH_CONFIG
    from hector_slam_tpu.io.checkpoint import load_state
    from hector_slam_tpu.parallel.onehot_match import (auto_num_buckets,
                                                       match_hypotheses_mxu)
    from hector_slam_tpu.session import SlamSession
    from hector_slam_tpu.types import Scan

    with np.load(state_path) as z:
        scan = Scan(*(jnp.asarray(z[k]) for k in ("scan_points",
                                                  "scan_origo",
                                                  "scan_mask")))
    state = load_state(state_path, BENCH_CONFIG)
    kidnapped = state._replace(pose=state.pose + jnp.asarray(KIDNAP))
    seen = {}
    refine = SlamSession._refine_and_accept

    def spy(self, hyp, *args, **kwargs):
        seen["hyp"] = np.asarray(hyp)
        return refine(self, hyp, *args, **kwargs)

    SlamSession._refine_and_accept = spy
    out = {"kidnap": KIDNAP, "sizes": np.asarray(SIZES, np.int32)}
    try:
        for n in SIZES:
            sess = SlamSession(BENCH_CONFIG)
            sess.state = kidnapped
            sess._last_scan = scan
            got = sess.relocalize(n_hypotheses=n, **RELOCALIZE)
            hyp = seen["hyp"]
            _, diag = match_hypotheses_mxu(
                kidnapped.log_odds, jnp.asarray(hyp), scan, BENCH_CONFIG,
                num_buckets=auto_num_buckets(hyp), with_diag=True)
            out.update({
                f"refine_hyp_{n}": hyp,
                f"pose_{n}": np.asarray(got["pose"], np.float32),
                f"residual_{n}": np.float32(got["residual"]),
                f"accepted_{n}": np.bool_(got["accepted"]),
                f"fast_path_fraction_{n}": np.float64(
                    got["fast_path_fraction"]),
                f"overflow_steps_{n}": np.int32(got["overflow_steps"]),
                f"eager_diag_{n}": np.asarray([float(d) for d in diag],
                                              np.float64)})
    finally:
        SlamSession._refine_and_accept = refine
    return out


def main() -> None:
    sys.path.insert(0, REPO)
    ref = jax_mxu_reference()
    np.savez_compressed(REFERENCE, **ref)
    for n in SIZES:
        print(f"n={n}: fast_path_fraction "
              f"{float(ref[f'fast_path_fraction_{n}'])!r}, overflow_steps "
              f"{int(ref[f'overflow_steps_{n}'])}, accepted "
              f"{bool(ref[f'accepted_{n}'])}, pose {ref[f'pose_{n}']}, "
              f"op-by-op diag {ref[f'eager_diag_{n}'].tolist()}")
    print(f"wrote {REFERENCE}")


if __name__ == "__main__":
    main()
