"""Laps of many robots through ONE world, in one common frame: the traffic
of a fleet that maps one building into one shared map.

The same seed gives the same inputs. The seed draws one world (the
``multi_room`` clutter, shared by every robot) and, for each robot, its
own start on the loop, its own weave and its own range noise. Robots do
not see one another: each robot's ranges are the walls' and the
clutter's alone.

The common frame is the map's world frame: the world's centre at its
origin, the world's axes, so the map (``start_coords`` (0.5, 0.5))
holds the whole building about its centre. Each robot's true poses are
given in that frame, and its first pose is where its SLAM pose starts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import traffic, world


@dataclasses.dataclass
class SharedLaps:
    """Each robot's closed lap in the common frame."""

    poses: np.ndarray      # f64[R, L, 3] true poses, common frame
    ranges: torch.Tensor   # f32[R, L, B] on the device

    @property
    def starts(self) -> np.ndarray:
        """f32[R, 3]: each robot's first pose, where its SLAM pose
        starts."""
        return self.poses[:, 0].astype(np.float32)


def make_shared_laps(tr: dict, laser: dict, robots: int, seed: int,
                     device) -> SharedLaps:
    rng = np.random.default_rng(traffic.seed_int(seed))
    w = tr["world"]
    n = tr["lap_scans"]
    jitter = rng.uniform(-w["clutter_jitter_m"], w["clutter_jitter_m"],
                         (10, 2))
    phases = rng.uniform(0.0, 2.0 * np.pi, (robots, 2))
    segs = world.multi_room(w["size_m"], w["door_m"], jitter)
    laps = np.stack([world.loop_lap(n, w["size_m"], p, tr["weave_rad"], q)
                     for p, q in phases])
    f64 = dict(dtype=torch.float64, device=device)
    segments = torch.tensor(segs, **f64)[None].expand(robots, -1, -1)
    ranges = world.raycast(segments, torch.tensor(laps, **f64),
                           torch.tensor(traffic.laser_angles(laser), **f64),
                           laser["range_min"], laser["range_max"])
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.seed_int(seed))
    noise = torch.randn(ranges.shape, generator=gen, device=device,
                        dtype=torch.float32)
    ranges = ranges + tr["range_noise_m"] * noise
    centre = w["size_m"] / 2.0
    poses = laps - np.array([centre, centre, 0.0])
    return SharedLaps(poses=poses, ranges=ranges)
