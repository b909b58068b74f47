"""Synthetic 2D world + laser raycast simulator for test fixtures.

The reference ships no bags, tests, or fixtures (SURVEY.md §4) — recorded
data must be synthesized. This simulator raycasts a polygon world with a
UTM-30LX-style laser model to produce scan logs with ground-truth poses,
used by the integration tests and benchmarks (BASELINE.json configs 1-3).

A numpy copy of ``hector_slam_tpu/io/simulator.py`` that imports the
port's own ``scanlog`` (host-side fixture generation, no tensors).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .scanlog import LaserModel


@dataclasses.dataclass
class World:
    """A set of line-segment walls: segments f32[S, 4] as (x0,y0,x1,y1)."""

    segments: np.ndarray

    @staticmethod
    def corridor(length: float = 20.0, width: float = 3.0,
                 with_clutter: bool = True) -> "World":
        """A closed corridor with a few boxes for rotation observability."""
        hw = width / 2.0
        segs: List[Tuple[float, float, float, float]] = [
            (-2.0, -hw, length, -hw),
            (-2.0, hw, length, hw),
            (-2.0, -hw, -2.0, hw),
            (length, -hw, length, hw),
        ]
        if with_clutter:
            for bx, by, s in [(3.0, -0.8, 0.4), (7.0, 0.7, 0.5),
                              (11.0, -0.5, 0.3), (15.0, 0.6, 0.45)]:
                segs += box(bx, by, s)
        return World(np.asarray(segs, np.float64))

    @staticmethod
    def l_corridor(leg_x: float = 12.0, leg_y: float = 14.0,
                   width: float = 3.0, with_clutter: bool = True) -> "World":
        """An L-shaped corridor (horizontal leg along +x, vertical leg
        along +y) — long grazing-incidence walls, a 90-degree turn, and
        pillar/box clutter. The realistic-log fixture world
        (tools/make_fixture.py)."""
        hw = width / 2.0
        x1 = leg_x               # outer right wall x
        x0 = leg_x - width       # inner left wall x of the vertical leg
        segs: List[Tuple[float, float, float, float]] = [
            (-2.0, -hw, x1, -hw),        # bottom wall
            (x1, -hw, x1, leg_y),        # outer right wall (vertical leg)
            (x1, leg_y, x0, leg_y),      # top cap
            (x0, leg_y, x0, hw),         # inner left wall (vertical leg)
            (x0, hw, -2.0, hw),          # top wall (horizontal leg)
            (-2.0, -hw, -2.0, hw),       # start cap
        ]
        if with_clutter:
            # boxes along the horizontal leg
            for bx, by, s in [(2.5, -0.9, 0.35), (5.5, 0.8, 0.4),
                              (8.0, -0.6, 0.3)]:
                segs += box(bx, by, s)
            # thin pillars (grazing + small features)
            for px, py in [(4.0, 0.2), (7.0, -0.2), (x0 + hw, 4.0),
                           (x0 + hw - 0.6, 8.0)]:
                segs += box(px, py, 0.12)
            # boxes in the vertical leg
            for bx, by, s in [(x0 + 0.7, 6.0, 0.35), (x1 - 0.7, 10.0, 0.4)]:
                segs += box(bx, by, s)
        return World(np.asarray(segs, np.float64))

    @staticmethod
    def room(size: float = 12.0, with_clutter: bool = True) -> "World":
        h = size / 2.0
        segs = [(-h, -h, h, -h), (h, -h, h, h), (h, h, -h, h), (-h, h, -h, -h)]
        if with_clutter:
            segs += box(2.5, 1.5, 0.6) + box(-2.0, -2.5, 0.8) + \
                box(-3.0, 2.0, 0.5) + box(3.5, -3.0, 0.7)
        return World(np.asarray(segs, np.float64))

    @staticmethod
    def multi_room(size: float = 12.0, door: float = 1.2,
                   with_clutter: bool = True) -> "World":
        """Four rooms in a 2x2 grid with doorways centered on the four
        points (size/4, size/2), (size/2, size/4), (3size/4, size/2),
        (size/2, 3size/4) — a radius-size/4 circle about the center
        passes through all four doors, so ``loop_trajectory`` visits
        every room and REVISITS its start (loop-closure-style content
        the single-corridor fixture lacks; round-4 VERDICT #4)."""
        s, h, q, d = size, size / 2.0, size / 4.0, door / 2.0
        segs: List[Tuple[float, float, float, float]] = [
            (0.0, 0.0, s, 0.0), (s, 0.0, s, s),
            (s, s, 0.0, s), (0.0, s, 0.0, 0.0),
            # vertical divider x = h with doors at y = q and y = 3q
            (h, 0.0, h, q - d), (h, q + d, h, 3 * q - d), (h, 3 * q + d, h, s),
            # horizontal divider y = h with doors at x = q and x = 3q
            (0.0, h, q - d, h), (q + d, h, 3 * q - d, h), (3 * q + d, h, s, h),
        ]
        if with_clutter:
            # per-room boxes/pillars placed off the loop circle
            for bx, by, bs in [(1.2, 1.3, 0.35), (4.7, 4.6, 0.3),
                               (s - 1.3, 1.4, 0.4), (7.4, 4.7, 0.25),
                               (s - 1.2, s - 1.4, 0.35), (7.3, 7.5, 0.3),
                               (1.3, s - 1.2, 0.4), (4.6, 7.4, 0.25),
                               (2.2, 5.0, 0.15), (s - 2.3, 7.0, 0.15)]:
                segs += box(bx, by, bs)
        return World(np.asarray(segs, np.float64))


def box(cx: float, cy: float, half: float):
    return [
        (cx - half, cy - half, cx + half, cy - half),
        (cx + half, cy - half, cx + half, cy + half),
        (cx + half, cy + half, cx - half, cy + half),
        (cx - half, cy + half, cx - half, cy - half),
    ]


def raycast(world: World, pose: np.ndarray,
            laser: LaserModel = LaserModel()) -> np.ndarray:
    """Vectorized ray/segment intersection. Returns ranges f32[num_beams]
    (range_max where nothing is hit)."""
    px, py, theta = float(pose[0]), float(pose[1]), float(pose[2])
    ang = laser.angles.astype(np.float64) + theta
    dx = np.cos(ang)                       # [B]
    dy = np.sin(ang)
    s = world.segments                     # [S, 4]
    x0, y0 = s[:, 0], s[:, 1]
    ex_, ey_ = s[:, 2] - x0, s[:, 3] - y0   # segment direction [S]

    # solve p + t*d = a + u*e for each (beam, segment)
    # t = cross(a - p, e) / cross(d, e); u = cross(a - p, d) / cross(d, e)
    apx = x0[None, :] - px                 # [1,S]
    apy = y0[None, :] - py
    denom = dx[:, None] * ey_[None, :] - dy[:, None] * ex_[None, :]  # [B,S]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (apx * ey_[None, :] - apy * ex_[None, :]) / denom
        u = (apx * dy[:, None] - apy * dx[:, None]) / denom
    hit = (np.abs(denom) > 1e-12) & (t > laser.range_min) & \
        (u >= 0.0) & (u <= 1.0)
    t = np.where(hit, t, np.inf)
    ranges = t.min(axis=1)
    return np.where(np.isfinite(ranges), ranges,
                    laser.range_max).astype(np.float32)


def simulate_trajectory(
    world: World,
    poses: np.ndarray,
    laser: LaserModel = LaserModel(),
    range_noise_std: float = 0.0,
    seed: int = 0,
    transients: Sequence[Tuple[np.ndarray, int, int]] = (),
    dropout_bursts: Sequence[Tuple[int, int, int, int]] = (),
) -> np.ndarray:
    """Raycast a sequence of poses -> ranges f32[T, num_beams].

    Adverse-content hooks (round-4 VERDICT #4):
      ``transients``: (segments f32[S,4], t_on, t_off) tuples — walls
        present only for scans t_on <= t < t_off (dynamic obstacles:
        the map integrates them while present, then the matcher must
        track against partially-stale cells once they vanish).
      ``dropout_bursts``: (t_on, t_off, beam_lo, beam_hi) tuples —
        those beams return 0.0 (below range_min, so the scan converter
        masks them invalid) for scans in the window: sensor-failure
        bursts up to whole-scan blackouts (empty scans pin the
        reference's return-input behavior, ScanMatcher.h:189).
    """
    rng = np.random.default_rng(seed)
    out = np.empty((len(poses), laser.num_beams), np.float32)
    for i, pose in enumerate(poses):
        active = [s for s, t_on, t_off in transients if t_on <= i < t_off]
        w = (World(np.concatenate([world.segments]
                                  + [np.asarray(s, np.float64).reshape(-1, 4)
                                     for s in active]))
             if active else world)
        r = raycast(w, pose, laser)
        if range_noise_std > 0.0:
            r = r + rng.normal(0.0, range_noise_std,
                               r.shape).astype(np.float32)
        for t_on, t_off, b_lo, b_hi in dropout_bursts:
            if t_on <= i < t_off:
                r[b_lo:b_hi] = 0.0
        out[i] = r
    return out


def corridor_trajectory(num_steps: int = 60, advance: float = 0.25,
                        weave: float = 0.06) -> np.ndarray:
    """A gently weaving forward path through the corridor world."""
    t = np.arange(num_steps)
    x = t * advance
    y = weave * np.sin(t * 0.3)
    theta = weave * 1.2 * np.cos(t * 0.3)
    return np.stack([x, y, theta], axis=-1).astype(np.float32)


def l_corridor_trajectory(advance: float = 0.05, weave: float = 0.03,
                          leg_x: float = 12.0, leg_y: float = 14.0,
                          width: float = 3.0) -> np.ndarray:
    """Drive down the horizontal leg of World.l_corridor, take the
    90-degree left turn, continue up the vertical leg. Step size
    ``advance`` (m), gentle weave; heading follows the path tangent."""
    cx = leg_x - width / 2.0      # vertical-leg centerline x
    turn_r = width / 2.0 + 0.3    # turn radius around the inner corner
    # straight along +x until the turn entry
    x_end = cx - turn_r
    n1 = max(2, int(round(x_end / advance)))
    t1 = np.arange(n1)
    p1 = np.stack([t1 * advance,
                   weave * np.sin(t1 * 0.25),
                   weave * 1.2 * np.cos(t1 * 0.25)], axis=-1)
    # quarter-circle turn: center (x_end, turn_r)
    arc_len = 0.5 * np.pi * turn_r
    n2 = max(4, int(round(arc_len / advance)))
    a = np.linspace(-np.pi / 2.0, 0.0, n2, endpoint=False)
    p2 = np.stack([x_end + turn_r * np.cos(a),
                   turn_r + turn_r * np.sin(a),
                   a + np.pi / 2.0], axis=-1)
    # straight along +y to near the cap
    y_start = turn_r
    n3 = max(2, int(round((leg_y - 2.0 - y_start) / advance)))
    t3 = np.arange(n3)
    p3 = np.stack([cx + weave * np.sin(t3 * 0.25),
                   y_start + t3 * advance,
                   np.pi / 2.0 + weave * 1.2 * np.cos(t3 * 0.25)], axis=-1)
    return np.concatenate([p1, p2, p3]).astype(np.float32)


def loop_trajectory(num_steps: int = 260, size: float = 12.0,
                    revisit_frac: float = 0.3,
                    weave: float = 0.0) -> np.ndarray:
    """The ``World.multi_room`` loop: a circle of radius size/4 about the
    floor-plan center, threading all four doorways, driven for
    (1 + revisit_frac) revolutions so the tail REVISITS mapped rooms —
    the matcher then localizes against cells integrated hundreds of
    scans earlier (open-loop drift shows up as re-entry error)."""
    c = size / 2.0
    r = size / 4.0
    a = np.linspace(0.0, 2.0 * np.pi * (1.0 + revisit_frac), num_steps)
    x = c + r * np.cos(a)
    y = c + r * np.sin(a)
    theta = a + np.pi / 2.0
    if weave > 0.0:
        theta = theta + weave * np.sin(np.arange(num_steps) * 0.3)
    # keep theta in (-2pi, 2pi): the engine-wide normalize_angle domain
    theta = np.arctan2(np.sin(theta), np.cos(theta))
    return np.stack([x, y, theta], axis=-1).astype(np.float32)


def room_trajectory(num_steps: int = 80, radius: float = 2.5) -> np.ndarray:
    """A loop inside the room world (exercises all heading angles)."""
    a = np.linspace(0.0, 2.0 * np.pi, num_steps, endpoint=False)
    x = radius * np.cos(a)
    y = radius * np.sin(a)
    theta = a + np.pi / 2.0
    return np.stack([x, y, theta], axis=-1).astype(np.float32)
