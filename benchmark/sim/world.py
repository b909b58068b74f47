"""The benchmark's own simulator: a polygon world, robot laps through it
and a laser raycast, frozen so that later changes to the program cannot
move the traffic.

Copied from ``hector_slam_tpu_torch/io/simulator.py`` (``World.multi_room``,
``box``, ``loop_trajectory``, ``raycast``) with three changes: the raycast
runs in torch on any device, batched over robots and scans; the clutter
boxes can be jittered from a generator; and a lap closes on itself
(its last pose is one step before its first), so laps replayed back to
back make one continuous path.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch


def box(cx: float, cy: float, half: float) -> List[Tuple[float, ...]]:
    return [(cx - half, cy - half, cx + half, cy - half),
            (cx + half, cy - half, cx + half, cy + half),
            (cx + half, cy + half, cx - half, cy + half),
            (cx - half, cy + half, cx - half, cy - half)]


# per-room boxes and pillars (x, y, half size), placed off the loop circle
_CLUTTER = ((1.2, 1.3, 0.35), (4.7, 4.6, 0.3), (-1.3, 1.4, 0.4),
            (7.4, 4.7, 0.25), (-1.2, -1.4, 0.35), (7.3, 7.5, 0.3),
            (1.3, -1.2, 0.4), (4.6, 7.4, 0.25), (2.2, 5.0, 0.15),
            (-2.3, 7.0, 0.15))


def multi_room(size: float, door: float, jitter: np.ndarray) -> np.ndarray:
    """Four rooms in a 2x2 grid with a doorway in each divider half, as
    ``World.multi_room``: segments f64[S, 4] (x0, y0, x1, y1). A negative
    clutter coordinate counts from the far wall. ``jitter`` f64[10, 2]
    moves each clutter box (zeros: the original world)."""
    s, h, q, d = size, size / 2.0, size / 4.0, door / 2.0
    segs = [(0.0, 0.0, s, 0.0), (s, 0.0, s, s), (s, s, 0.0, s),
            (0.0, s, 0.0, 0.0),
            (h, 0.0, h, q - d), (h, q + d, h, 3 * q - d), (h, 3 * q + d, h, s),
            (0.0, h, q - d, h), (q + d, h, 3 * q - d, h), (3 * q + d, h, s, h)]
    for (bx, by, half), (jx, jy) in zip(_CLUTTER, jitter):
        segs += box((bx if bx >= 0 else s + bx) + jx,
                    (by if by >= 0 else s + by) + jy, half)
    return np.asarray(segs, np.float64)


def loop_lap(num_steps: int, size: float, phase: float, weave: float,
             weave_phase: float) -> np.ndarray:
    """One closed lap of the ``World.multi_room`` loop (``loop_trajectory``'s
    circle of radius size/4 about the centre, through all four doors),
    starting at angle ``phase``: poses f64[num_steps, 3], heading along the
    tangent plus a weave of amplitude ``weave`` rad."""
    c, r = size / 2.0, size / 4.0
    a = phase + np.arange(num_steps) * (2.0 * np.pi / num_steps)
    theta = a + np.pi / 2.0 + weave * np.sin(
        weave_phase + np.arange(num_steps) * (2.0 * np.pi * 8 / num_steps))
    theta = np.arctan2(np.sin(theta), np.cos(theta))
    return np.stack([c + r * np.cos(a), c + r * np.sin(a), theta], -1)


def raycast(segments: torch.Tensor, poses: torch.Tensor,
            angles: torch.Tensor, range_min: float, range_max: float,
            budget: int = 2 ** 25) -> torch.Tensor:
    """Ray/segment intersection, ``simulator.raycast`` batched: segments
    f64[R, S, 4] (a world per robot), poses f64[R, T, 3], beam angles
    f64[B]. Returns ranges f32[R, T, B], ``range_max`` where nothing is
    hit. Scans go in chunks of at most ``budget`` (beam, segment) pairs."""
    r_count, t_count = poses.shape[:2]
    chunk = max(1, budget // (r_count * angles.shape[0] * segments.shape[1]))
    out = torch.empty((r_count, t_count, angles.shape[0]), dtype=torch.float32,
                      device=poses.device)
    x0, y0 = segments[..., 0], segments[..., 1]                 # [R, S]
    ex, ey = segments[..., 2] - x0, segments[..., 3] - y0
    for lo in range(0, t_count, chunk):
        p = poses[:, lo:lo + chunk]                              # [R, t, 3]
        ang = p[..., 2:3] + angles                               # [R, t, B]
        dx, dy = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
        apx = (x0[:, None, :] - p[..., 0:1])[:, :, None, :]      # [R,t,1,S]
        apy = (y0[:, None, :] - p[..., 1:2])[:, :, None, :]
        sx, sy = ex[:, None, None, :], ey[:, None, None, :]
        denom = dx * sy - dy * sx                                # [R,t,B,S]
        ok = denom.abs() > 1e-12
        safe = torch.where(ok, denom, torch.ones_like(denom))
        t = (apx * sy - apy * sx) / safe
        u = (apx * dy - apy * dx) / safe
        hit = ok & (t > range_min) & (u >= 0.0) & (u <= 1.0)
        t = torch.where(hit, t, torch.full_like(t, math.inf)).amin(-1)
        out[:, lo:lo + chunk] = torch.where(
            torch.isfinite(t), t, torch.full_like(t, range_max)).float()
    return out
