"""The one traffic generator: a traffic file's parameters and a seed in,
each robot's laps of scans out.

A traffic file (``benchmark/traffic/<mix>.json``) gives the world, the
lap, the noise and the driver that runs the cell's window; the
configuration gives the laser and the robot count. The same seed gives
the same inputs. Every seed gets the same amount of work: the same lap
length, robot count and scans per lap; the seed moves the clutter, each
robot's start on the loop, its weave and the range noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import world


@dataclasses.dataclass
class Laps:
    """Each robot's closed lap: its true poses in its own SLAM frame (the
    frame of its first pose, where the program's pose starts at zero) and
    its ranges."""

    poses: np.ndarray      # f64[R, L, 3] true poses, SLAM frame
    ranges: torch.Tensor   # f32[R, L, B] on the device


def seed_int(seed: int) -> int:
    """Any whole number as a seed both numpy and torch accept."""
    return int(seed) % (2 ** 63)


def laser_angles(laser: dict) -> np.ndarray:
    """f32[B] beam angles, as ``LaserModel.angles`` computes them."""
    return (laser["angle_min"] + np.arange(laser["num_beams"])
            * laser["angle_increment"]).astype(np.float32)


def to_slam_frame(poses: np.ndarray) -> np.ndarray:
    """Poses f64[..., L, 3] relative to each lap's first pose."""
    start = poses[..., :1, :]
    c, s = np.cos(start[..., 2]), np.sin(start[..., 2])
    dx, dy = poses[..., 0] - start[..., 0], poses[..., 1] - start[..., 1]
    theta = poses[..., 2] - start[..., 2]
    return np.stack([c * dx + s * dy, -s * dx + c * dy,
                     np.arctan2(np.sin(theta), np.cos(theta))], -1)


def make_laps(traffic: dict, laser: dict, robots: int, seed: int,
              device) -> Laps:
    rng = np.random.default_rng(seed_int(seed))
    w = traffic["world"]
    n = traffic["lap_scans"]
    jitter = rng.uniform(-w["clutter_jitter_m"], w["clutter_jitter_m"],
                         (robots, 10, 2))
    phases = rng.uniform(0.0, 2.0 * np.pi, (robots, 2))
    segs = np.stack([world.multi_room(w["size_m"], w["door_m"], j)
                     for j in jitter])
    laps = np.stack([world.loop_lap(n, w["size_m"], p, traffic["weave_rad"],
                                    q) for p, q in phases])
    f64 = dict(dtype=torch.float64, device=device)
    ranges = world.raycast(torch.tensor(segs, **f64),
                           torch.tensor(laps, **f64),
                           torch.tensor(laser_angles(laser), **f64),
                           laser["range_min"], laser["range_max"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_int(seed))
    noise = torch.randn(ranges.shape, generator=gen, device=device,
                        dtype=torch.float32)
    ranges = ranges + traffic["range_noise_m"] * noise
    return Laps(poses=to_slam_frame(laps), ranges=ranges)


def scans_from_ranges(ranges: torch.Tensor, laser: dict, scale: float,
                      max_beams: int):
    """The laser driver's conversion (rosLaserScanToDataContainer), batched
    on the device: ranges f32[..., B] -> (points f32[..., max_beams, 2] in
    map-scale units of the finest level, mask bool[..., max_beams]). Beams
    with range in (range_min, range_max - 0.1) are kept, in beam order,
    then padding."""
    angles = torch.tensor(laser_angles(laser), device=ranges.device)
    keep = (ranges > np.float32(laser["range_min"])) & (
        ranges < np.float32(laser["range_max"] - 0.1))
    dist = ranges * np.float32(scale)
    pts = torch.stack([torch.cos(angles) * dist, torch.sin(angles) * dist], -1)
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    pts = torch.gather(pts, -2, order[..., None].expand(pts.shape))
    keep = torch.gather(keep, -1, order)
    pad = max_beams - ranges.shape[-1]
    pts = torch.nn.functional.pad(torch.where(keep[..., None], pts, 0.0),
                                  (0, 0, 0, pad))
    return pts.contiguous(), torch.nn.functional.pad(keep, (0, pad))
