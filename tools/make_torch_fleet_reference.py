"""Writes the JAX reference of a shared-map fleet that the PyTorch port is
held against on the card, where JAX is not installed.

The scenario: R robots in one ``World.room(size=10)`` (one common frame),
seeded with known start poses on a ring of 0.8-1.2 m radius around the
room's centre, each heading roughly tangentially at its own speed
(0.05-0.10 m per scan) and yaw rate, scanned with the full 1081-beam
UTM-30LX (``LaserModel()``, 5 mm range noise). The JAX engine's
``shared_fleet_step_jit`` runs T steps on ``BENCH_CONFIG`` (1024^2 @
0.05 m, 3 levels), every robot matching against and integrating into ONE
pyramid. The file keeps the inputs (start poses, ranges f32[T, R, 1081])
and the results: poses f32[T, R, 3], gates bool[T, R], truncated cells
i32[T], the update count, and each level's counts of cells with log-odds
> 0 and < 0 after the last step.

    JAX_PLATFORMS=cpu python tools/make_torch_fleet_reference.py \\
        [--robots 64] [--steps 16] [--seed 0]

``chip_smoke.py`` replays the stored ranges through the port's
``shared_fleet_step`` and compares; tests/test_torch_fleet.py holds the
port to a freshly generated small version and checks that the committed
file is the one these defaults write.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "tests", "fixtures",
                         "shared_fleet_jax_reference.npz")
DEFAULT_ROBOTS = 64
DEFAULT_STEPS = 16   # the robots stay 0.2 m clear of the room's boxes
DEFAULT_SEED = 0
CONFIG_NAME = "BENCH_CONFIG"
ROOM_SIZE = 10.0
RANGE_NOISE_STD = 0.005


def scenario(num_robots: int, steps: int, seed: int):
    """(start poses f32[R, 3], true poses f32[T, R, 3], ranges
    f32[T, R, 1081]) of the shared-room fleet. Numpy only."""
    sys.path.insert(0, REPO)
    from hector_slam_tpu.io.scanlog import LaserModel
    from hector_slam_tpu.io.simulator import World, simulate_trajectory
    rng = np.random.default_rng(seed)
    ang = (2.0 * np.pi * np.arange(num_robots) / num_robots
           + rng.uniform(-0.05, 0.05, num_robots))
    radius = rng.uniform(0.8, 1.2, num_robots)
    heading = ang + np.pi / 2 + rng.uniform(-0.3, 0.3, num_robots)
    speed = rng.uniform(0.05, 0.10, num_robots)
    yaw_rate = rng.uniform(-0.02, 0.02, num_robots)
    x, y, th = radius * np.cos(ang), radius * np.sin(ang), heading
    poses = []
    for _ in range(steps):
        poses.append(np.stack([x, y, th], -1))
        x = x + speed * np.cos(th)
        y = y + speed * np.sin(th)
        th = th + yaw_rate
    poses = np.asarray(poses, np.float32)                    # [T, R, 3]
    world = World.room(size=ROOM_SIZE)
    laser = LaserModel()
    ranges = np.stack([simulate_trajectory(world, poses[t], laser,
                                           range_noise_std=RANGE_NOISE_STD,
                                           seed=seed * 1000 + t)
                       for t in range(steps)])               # [T, R, B]
    return poses[0].copy(), poses, ranges


def shared_fleet_reference(cfg=None, num_robots: int = DEFAULT_ROBOTS,
                           steps: int = DEFAULT_STEPS,
                           seed: int = DEFAULT_SEED) -> dict:
    """The JAX run of ``scenario`` on ``cfg`` (default BENCH_CONFIG), as
    numpy arrays."""
    sys.path.insert(0, REPO)
    import jax
    from hector_slam_tpu.config import BENCH_CONFIG
    from hector_slam_tpu.io.scanlog import (LaserModel, scan_from_ranges,
                                            stack_scans)
    from hector_slam_tpu.parallel.shared_map import (init_shared_fleet,
                                                     shared_fleet_step_jit)
    cfg = BENCH_CONFIG if cfg is None else cfg
    starts, _, ranges = scenario(num_robots, steps, seed)
    laser = LaserModel()
    scale = cfg.map.level_scale(0)
    state = init_shared_fleet(cfg, num_robots, start_poses=starts)
    poses, gates, truncated = [], [], []
    for t in range(steps):
        scans = stack_scans([scan_from_ranges(r, scale, laser, cfg.max_beams)
                             for r in ranges[t]])
        state, metrics = shared_fleet_step_jit(state, scans, cfg)
        poses.append(np.asarray(state.pose))
        gates.append(np.asarray(metrics.map_updated))
        truncated.append(int(metrics.truncated_free_cells))
    jax.block_until_ready(state.pose)
    levels = [np.asarray(lo) for lo in state.log_odds]
    return dict(
        robots=np.int32(num_robots), steps=np.int32(steps),
        seed=np.int32(seed), config=np.str_(CONFIG_NAME),
        start_poses=starts, ranges=ranges,
        poses=np.asarray(poses, np.float32),
        map_updated=np.asarray(gates, bool),
        truncated_free_cells=np.asarray(truncated, np.int32),
        map_update_count=np.int32(state.map_update_count),
        occupied_cells=np.asarray([(lo > 0).sum() for lo in levels],
                                  np.int64),
        free_cells=np.asarray([(lo < 0).sum() for lo in levels], np.int64))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robots", type=int, default=DEFAULT_ROBOTS)
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument("--out", default=REFERENCE)
    args = ap.parse_args()
    ref = shared_fleet_reference(None, args.robots, args.steps, args.seed)
    np.savez_compressed(args.out, **ref)
    print(f"wrote {args.out}: {args.robots} robots x {args.steps} steps, "
          f"{int(ref['map_update_count'])} map updates, gates per step "
          f"{ref['map_updated'].sum(1).tolist()}")


if __name__ == "__main__":
    main()
