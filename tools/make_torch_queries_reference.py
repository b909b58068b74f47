"""Writes the JAX reference that the PyTorch port's query modules are held
against on the card, where JAX is not installed
(tests/fixtures/queries_jax_reference.npz; ``chip_smoke.py`` phase
``queries``).

Scenario, on ``BENCH_CONFIG`` (1024^2 @ 0.05 m, 3 levels):
  1. the JAX ``SlamSession`` replays the committed corridor fixture
     (tests/fixtures/corridor_utm30lx.npz, 435 scans of 1081 beams) through
     ``process_ranges`` with stamps t x 0.025 s, as
     tools/make_torch_session_reference.py does;
  2. its final state is written with the JAX ``save_state``: the file IS a
     JAX checkpoint (``leaf_<i>``, ``num_levels``), so the port's
     ``load_state`` reads the map from it;
  3. beside the checkpoint, the query inputs and JAX's answers:
     - ``sigma_point_covariance`` and ``likelihood_for_state`` at the final
       pose (level-0 map frame) with the last scan;
     - ``match_pyramid_debug`` of the last scan from the pose before it
       (6 + 4 + 4 GN iterations: pose, Hessians, determinants, condition
       numbers);
     - ``distance_to_obstacle_batch`` of 65,536 rays with max_cells 1024:
       1,024 start cells drawn from the free cells of the finest
       occupancy grid, 64 headings each, every ray 600 cells long (30 m,
       the laser's range) with its end clipped into the map;
     - the scalar ``distance_to_obstacle``, ``get_distance_to_obstacle``
       (3D query points) and ``get_normal`` of 64 rays from the final pose
       (``get_normal``'s None as NaN).

    JAX_PLATFORMS=cpu python tools/make_torch_queries_reference.py

On a CPU this runs for about half a minute and peaks near 2 GB of resident
memory (the batch raycast holds [65,536, 1,024] int32 tensors).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "corridor_utm30lx.npz")
REFERENCE = os.path.join(REPO, "tests", "fixtures",
                         "queries_jax_reference.npz")
STAMP_S = 0.025
RAY_STARTS, RAY_HEADINGS, RAY_CELLS, MAX_CELLS = 1024, 64, 600, 1024
SCALAR_RAYS = 64
SEED = 8


def ray_inputs(occ: np.ndarray, seed: int = SEED):
    """(begins, ends) i32[RAY_STARTS * RAY_HEADINGS, 2] map cells: start
    cells drawn from the free cells of ``occ``, RAY_HEADINGS headings
    each, ends RAY_CELLS away clipped into the map."""
    rng = np.random.default_rng(seed)
    ys, xs = np.nonzero(occ == 0)
    pick = rng.choice(len(xs), RAY_STARTS, replace=False)
    starts = np.stack([xs[pick], ys[pick]], -1)
    ang = np.linspace(-np.pi, np.pi, RAY_HEADINGS, endpoint=False)
    step = np.round(RAY_CELLS * np.stack([np.cos(ang), np.sin(ang)], -1))
    begins = np.repeat(starts, RAY_HEADINGS, 0)
    ends = begins + np.tile(step, (RAY_STARTS, 1)).astype(np.int64)
    hi = np.asarray(occ.shape[::-1]) - 1
    return (begins.astype(np.int32),
            np.clip(ends, 0, hi).astype(np.int32))


def scalar_inputs(pose: np.ndarray):
    """(robot [2], points [SCALAR_RAYS, 3]): 3D query points 4 m from the
    robot on SCALAR_RAYS headings, 0.5 m above its plane."""
    ang = np.linspace(-np.pi, np.pi, SCALAR_RAYS, endpoint=False)
    pts = np.stack([pose[0] + 4.0 * np.cos(ang), pose[1] + 4.0 * np.sin(ang),
                    np.full(SCALAR_RAYS, 0.5)], -1)
    return np.asarray(pose[:2], np.float64), pts


def jax_queries_reference(fixture: str = FIXTURE) -> dict:
    """The scenario above through the JAX package, as numpy arrays."""
    import jax.numpy as jnp
    from hector_slam_tpu.config import BENCH_CONFIG as cfg
    from hector_slam_tpu.core.covariance import (likelihood_for_state,
                                                 sigma_point_covariance)
    from hector_slam_tpu.core.debug import match_pyramid_debug_jit
    from hector_slam_tpu.core.grid import world_to_map_pose
    from hector_slam_tpu.export.occupancy import grid_meta, to_occupancy_grid
    from hector_slam_tpu.io.checkpoint import save_state
    from hector_slam_tpu.io.scanlog import load_log, scan_from_ranges
    from hector_slam_tpu.query.raycast import (distance_to_obstacle,
                                               distance_to_obstacle_batch,
                                               get_distance_to_obstacle,
                                               get_normal)
    from hector_slam_tpu.session import SlamSession
    ranges, laser, _ = load_log(fixture)
    sess = SlamSession(cfg, laser)
    poses = np.stack([sess.process_ranges(r, stamp=t * STAMP_S)
                      for t, r in enumerate(ranges)]).astype(np.float32)
    state = sess.state
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_state(path, state)
        with np.load(path) as z:
            out = {k: z[k] for k in z.files}

    scan = scan_from_ranges(ranges[-1], cfg.map.level_scale(0), laser,
                            cfg.max_beams)
    pm = world_to_map_pose(jnp.asarray(poses[-1]), cfg.map.top_left_offset,
                           cfg.map.level_scale(0))
    out.update(
        poses=poses, scan_points=np.asarray(scan.points),
        scan_origo=np.asarray(scan.origo), scan_mask=np.asarray(scan.mask),
        pose_map=np.asarray(pm),
        covariance=np.asarray(sigma_point_covariance(state.log_odds[0], pm,
                                                     scan)),
        likelihood=np.float32(likelihood_for_state(state.log_odds[0], pm,
                                                   scan)))
    dpose, dhess, diag = match_pyramid_debug_jit(
        state.log_odds, jnp.asarray(poses[-2]), scan, cfg)
    out.update(debug_start=poses[-2], debug_pose=np.asarray(dpose),
               debug_hessian=np.asarray(dhess),
               **{f"diag_{k}": np.asarray(v)
                  for k, v in diag._asdict().items()})

    occ = to_occupancy_grid(state.log_odds[0])
    begins, ends = ray_inputs(occ)
    out.update(ray_begins=begins, ray_ends=ends, ray_distances=np.asarray(
        distance_to_obstacle_batch(jnp.asarray(occ), jnp.asarray(begins),
                                   jnp.asarray(ends), max_cells=MAX_CELLS)))
    meta = grid_meta(cfg.map)
    robot, pts = scalar_inputs(poses[-1])
    dist, hits, service, normals = [], [], [], []
    for p in pts:
        d, h = distance_to_obstacle(occ, meta, robot, p[:2])
        dist.append(d)
        hits.append(np.full(2, np.nan) if h is None else h)
        service.append(get_distance_to_obstacle(occ, meta, robot, p))
        n = get_normal(occ, meta, robot, p)
        normals.append(np.full(2, np.nan) if n is None else n)
    out.update(scalar_robot=robot, scalar_points=pts,
               scalar_distances=np.asarray(dist, np.float64),
               scalar_hits=np.asarray(hits, np.float64),
               service_distances=np.asarray(service, np.float64),
               normals=np.asarray(normals, np.float64))
    return out


def main() -> None:
    sys.path.insert(0, REPO)
    ref = jax_queries_reference()
    np.savez_compressed(REFERENCE, **ref)
    print(f"wrote {REFERENCE} ({os.path.getsize(REFERENCE)} bytes): "
          f"{len(ref['poses'])} poses, "
          f"{int((ref['ray_distances'] >= 0).sum())} of "
          f"{len(ref['ray_distances'])} rays hit, "
          f"{int(np.isfinite(ref['scalar_hits'][:, 0]).sum())} of "
          f"{len(ref['scalar_hits'])} scalar rays hit; likelihood "
          f"{float(ref['likelihood'])}")


if __name__ == "__main__":
    main()
