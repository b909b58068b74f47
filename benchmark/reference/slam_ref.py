"""Plain reference of hector_slam's equations, in torch, batched.

A frozen, vectorised copy of the equations of
``hector_slam_tpu/oracle/oracle_np.py`` (itself a transcription of the
C++ reference, hector_mapping/include/hector_slam_lib/), written here
once so that no later change to the program can move it. It imports
nothing of the program or of the JAX package, and takes nothing the
program made: maps are rebuilt from the benchmark's inputs.

Every equation runs in a dtype the caller picks: float64 for the
reference (f32-rounded constants where the C++ stores a float: cell
length, scale, offset, thresholds, log-odds deltas), bfloat16 for the
lower-precision control. Differences from the serial oracle, all of
them exact rewrites:
  - a scan's update is the commutative set form of its serial Bresenham
    loop: new = old + lf * [free and not occupied] + lo * [occupied and
    old < 50] (occupied wins, once per scan), with the closed-form cell
    j of a ray at start + j*a + ((da//2 + j*db)//da)*b, every cell of
    every ray (no cap);
  - the Gauss-Newton sums are reductions over the beams;
  - the 3x3 solve is the adjugate over the determinant.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class Level:
    """One pyramid level's geometry (map/GridMapBase.h:265-280)."""

    size_x: int
    size_y: int
    scale: float          # f32(1) / f32(cell length)
    offset: tuple         # f32 top-left offset, shared by all levels
    iterations: int       # GN iterations (the matcher runs one more)


@dataclasses.dataclass(frozen=True)
class Params:
    levels: tuple
    log_odds_free: float
    log_odds_occupied: float
    clamp_occupied: float
    dist_thresh: float
    angle_thresh: float
    angle_clamp: float


def prob_to_log_odds(p: float) -> float:
    """GridMapLogOdds.h:199-203."""
    p = F32(p)
    return float(F32(math.log(float(p / (F32(1.0) - p)))))


def params(cfg: dict) -> Params:
    """The equations' constants from a configuration file's SlamConfig
    fields (``map``, ``match``, ``update``, the gate thresholds)."""
    m, mt, up = cfg["map"], cfg["match"], cfg["update"]
    if up["cell_model"] != "log_odds":
        raise ValueError("the reference implements the log-odds cell model")
    off = (float(F32(m["resolution"]) * F32(m["size_x"])
                 * F32(m["start_coords"][0])),
           float(F32(m["resolution"]) * F32(m["size_y"])
                 * F32(m["start_coords"][1])))
    levels = []
    for i in range(m["levels"]):
        cell = F32(m["resolution"] * 2.0 ** i)
        levels.append(Level(m["size_x"] >> i, m["size_y"] >> i,
                            float(F32(1.0) / cell), off,
                            mt["iterations_finest"] if i == 0
                            else mt["iterations_coarse"]))
    return Params(tuple(levels), prob_to_log_odds(up["update_factor_free"]),
                  prob_to_log_odds(up["update_factor_occupied"]),
                  float(F32(up["log_odds_clamp_occupied"])),
                  float(F32(cfg["map_update_distance_thresh"])),
                  float(F32(cfg["map_update_angle_thresh"])),
                  float(F32(mt["angle_step_clamp"])))


def init_maps(p: Params, maps: int, device, dtype) -> List[torch.Tensor]:
    """Reset log-odds levels [maps, H, W] (zeros, GridMapLogOdds.h:89)."""
    return [torch.zeros((maps, lv.size_y, lv.size_x), dtype=dtype,
                        device=device) for lv in p.levels]


def probabilities(log_odds: torch.Tensor) -> torch.Tensor:
    """GridMapLogOdds.h:163-167: odds / (odds + 1)."""
    odds = torch.exp(log_odds)
    return odds / (odds + 1.0)


def world_to_map(xy: torch.Tensor, lv: Level) -> torch.Tensor:
    s = F32(lv.scale)
    ox, oy = (float(F32(o) * s) for o in lv.offset)
    return torch.stack([xy[..., 0] * float(s) + ox,
                        xy[..., 1] * float(s) + oy], -1)


def map_to_world(xy: torch.Tensor, lv: Level) -> torch.Tensor:
    s = F32(lv.scale)
    inv_s = s * (F32(1.0) / (s * s))
    tx, ty = (float(inv_s * (F32(o) * s)) for o in lv.offset)
    return torch.stack([xy[..., 0] * float(inv_s) - tx,
                        xy[..., 1] * float(inv_s) - ty], -1)


def normalize_angle(a: torch.Tensor) -> torch.Tensor:
    """util/UtilFunctions.h:37-49: into (-pi, pi]."""
    two_pi = 2.0 * math.pi
    a = torch.fmod(torch.fmod(a, two_pi) + two_pi, two_pi)
    return torch.where(a > math.pi, a - two_pi, a)


def _transform(est, px, py):
    """The scan's points in map coords at estimates est [B, 3] (Eigen's
    m00*px + (m01*py + t))."""
    s = torch.sin(est[:, 2:3])
    c = torch.cos(est[:, 2:3])
    return (c * px + (-s * py + est[:, 0:1]),
            s * px + (c * py + est[:, 1:2]), s, c)


def interp(prob: torch.Tensor, which: torch.Tensor, x: torch.Tensor,
           y: torch.Tensor):
    """Bilinear value and the reference's gradients (OccGridMapUtil.h:
    287-347) at map coords x, y [B, N] on map which[b] of prob [M, H, W].
    Out of bounds (x < 0, x > W-2, likewise y; MapDimensionProperties.h:
    65-73) reads (0, 0, 0)."""
    _, h, w = prob.shape
    inb = (x >= 0) & (x <= w - 2) & (y >= 0) & (y <= h - 2)
    # cells clamped as integers: a float bound such as 2046 need not exist
    # in a low precision
    xi = torch.clamp(torch.trunc(x).to(torch.int64), 0, w - 2)
    yi = torch.clamp(torch.trunc(y).to(torch.int64), 0, h - 2)
    fx = x - xi.to(x.dtype)
    fy = y - yi.to(y.dtype)
    flat = prob.reshape(-1)
    i00 = which[:, None].to(torch.int64) * (h * w) + yi * w + xi
    p00, p10 = flat[i00], flat[i00 + 1]
    p01, p11 = flat[i00 + w], flat[i00 + w + 1]
    xfi, yfi = 1.0 - fx, 1.0 - fy
    value = (p00 * xfi + p10 * fx) * yfi + (p01 * xfi + p11 * fx) * fy
    # the quirk: the x gradient blends the row differences with the x
    # fraction, the y gradient the column differences with the y fraction
    gx = -((p00 - p10) * xfi + (p01 - p11) * fx)
    gy = -((p00 - p01) * yfi + (p10 - p11) * fy)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (torch.where(inb, value, zero), torch.where(inb, gx, zero),
            torch.where(inb, gy, zero))


def gn_step(prob, which, est, px, py, mask, clamp: float):
    """One estimateTransformationLogLh (ScanMatcher.h:194-226) for
    estimates est [B, 3] in map coords, points px, py [B, N] and mask
    [B, N]. Returns (new estimates, H [B, 3, 3])."""
    tx, ty, s, c = _transform(est, px, py)
    m, gx, gy = interp(prob, which, tx, ty)
    zero = torch.zeros((), dtype=est.dtype, device=est.device)
    f = torch.where(mask, 1.0 - m, zero)
    gx = torch.where(mask, gx, zero)
    gy = torch.where(mask, gy, zero)
    rot = (-s * px - c * py) * gx + (c * px - s * py) * gy
    d = torch.stack([(gx * f).sum(-1), (gy * f).sum(-1), (rot * f).sum(-1)],
                    -1)
    h00, h11, h22 = (gx * gx).sum(-1), (gy * gy).sum(-1), (rot * rot).sum(-1)
    h01, h02, h12 = (gx * gy).sum(-1), (gx * rot).sum(-1), (gy * rot).sum(-1)
    hess = torch.stack([torch.stack([h00, h01, h02], -1),
                        torch.stack([h01, h11, h12], -1),
                        torch.stack([h02, h12, h22], -1)], -2)
    guard = (h00 != 0) & (h11 != 0)
    c00 = h11 * h22 - h12 * h12
    c01 = h12 * h02 - h01 * h22
    c02 = h01 * h12 - h11 * h02
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    det = h00 * c00 + h01 * c01 + h02 * c02
    det = torch.where(guard & (det != 0), det, torch.ones_like(det))
    step = torch.stack([c00 * d[:, 0] + c01 * d[:, 1] + c02 * d[:, 2],
                        c01 * d[:, 0] + c11 * d[:, 1] + c12 * d[:, 2],
                        c02 * d[:, 0] + c12 * d[:, 1] + c22 * d[:, 2]],
                       -1) / det[:, None]
    step = torch.cat([step[:, :2], torch.clamp(step[:, 2:], -clamp, clamp)],
                     -1)
    return torch.where(guard[:, None], est + step, est), hess


def match(p: Params, probs: Sequence[torch.Tensor], which: torch.Tensor,
          start: torch.Tensor, points: torch.Tensor, mask: torch.Tensor):
    """MapRepMultiMap::matchData (MapRepMultiMap.h:116-132) with
    ScanMatcher::matchData per level (ScanMatcher.h:54-190): coarse to
    fine, (iterations + 1) GN steps a level, the scan scaled by 2^-level,
    the angle normalised and the pose back in world coords after each
    level; an empty scan returns the start. start [B, 3] world poses,
    points [B, N, 2] or [N, 2] (finest-level map units), mask likewise,
    which [B] the map of each. Returns world poses [B, 3]."""
    if points.dim() == 2:
        points = points.expand(start.shape[0], *points.shape)
        mask = mask.expand(start.shape[0], *mask.shape)
    pose = start
    for i in range(len(p.levels) - 1, -1, -1):
        lv = p.levels[i]
        factor = float(F32(1.0 / 2.0 ** i))
        px, py = points[..., 0] * factor, points[..., 1] * factor
        est = torch.cat([world_to_map(pose[:, :2], lv), pose[:, 2:]], -1)
        for _ in range(lv.iterations + 1):
            est, _ = gn_step(probs[i], which, est, px, py, mask, p.angle_clamp)
        pose = torch.cat([map_to_world(est[:, :2], lv),
                          normalize_angle(est[:, 2:])], -1)
    return torch.where(mask.any(-1)[:, None], pose, start)


def update(p: Params, maps: Sequence[torch.Tensor], which: torch.Tensor,
           poses: torch.Tensor, points: torch.Tensor, origo: torch.Tensor,
           mask: torch.Tensor) -> None:
    """OccGridMapBase::updateByScan (OccGridMapBase.h:121-260) of G scans
    at world poses [G, 3] into maps which[g] of the levels [M, H, W], in
    place; every level gets its own scaled scan (MapRepMultiMap.h:
    134-147). Scans into one map combine as one scan (the union of their
    cell sets)."""
    if which.numel() == 0:
        return
    for i, lv in enumerate(p.levels):
        grid = maps[i]
        h, w = lv.size_y, lv.size_x
        factor = float(F32(1.0 / 2.0 ** i))
        pts, org = points * factor, origo * factor
        pm = torch.cat([world_to_map(poses[:, :2], lv), poses[:, 2:]], -1)
        s, c = torch.sin(pm[:, 2:3]), torch.cos(pm[:, 2:3])

        def cell(px, py):
            # +0.5 then an int cast (OccGridMapBase.h:137, :148-155)
            return (torch.trunc(c * px + (-s * py + pm[:, 0:1]) + 0.5)
                    .to(torch.int64),
                    torch.trunc(s * px + (c * py + pm[:, 1:2]) + 0.5)
                    .to(torch.int64))

        bx, by = cell(org[:, 0:1], org[:, 1:2])                   # [G, 1]
        ex, ey = cell(pts[..., 0], pts[..., 1])                    # [G, N]
        valid = (mask & ((ex != bx) | (ey != by))
                 & (bx >= 0) & (bx < w) & (by >= 0) & (by < h)
                 & (ex >= 0) & (ex < w) & (ey >= 0) & (ey < h))
        dx, dy = ex - bx, ey - by
        x_dom = dx.abs() >= dy.abs()
        sx = torch.where(dx > 0, 1, -1)            # sign(0) == -1
        sy = torch.where(dy > 0, 1, -1) * w
        da = torch.where(x_dom, dx.abs(), dy.abs())
        db = torch.where(x_dom, dy.abs(), dx.abs())
        oa = torch.where(x_dom, sx, sy)
        ob = torch.where(x_dom, sy, sx)
        base = which[:, None].to(torch.int64) * (h * w)
        k = int(torch.where(valid, da, 0).max()) if bool(valid.any()) else 0
        free = torch.zeros(grid.numel(), dtype=torch.bool, device=grid.device)
        occ = torch.zeros_like(free)
        occ[(base + ey * w + ex)[valid]] = True
        for lo in range(0, k, 128):
            j = torch.arange(lo, min(k, lo + 128), device=grid.device)
            minor = (da[..., None] // 2 + j * db[..., None]) \
                // torch.clamp(da, min=1)[..., None]
            cells = (base + by * w + bx)[..., None] + j * oa[..., None] \
                + minor * ob[..., None]
            free[cells[valid[..., None] & (j < da[..., None])]] = True
        flat = grid.view(-1)
        flat += (p.log_odds_free * (free & ~occ).to(grid.dtype)
                 + p.log_odds_occupied
                 * (occ & (flat < p.clamp_occupied)).to(grid.dtype))


def gates(p: Params, poses: torch.Tensor, dtype=torch.float32
          ) -> torch.Tensor:
    """The map-update gate (HectorSlamProcessor.h:89-95, UtilFunctions.h:
    73-92) along a trajectory of poses [T, R, 3]: scan t of robot r
    updates its map when its pose moved more than the distance or the
    angle threshold from the pose of its last update (none yet: FLT_MAX,
    so the first scan updates). float32, the C++'s own precision, unless
    ``dtype`` says otherwise. Returns bool [T, R]."""
    poses = poses.to(dtype)
    t_count, r_count = poses.shape[:2]
    out = torch.ones((t_count, r_count), dtype=torch.bool)
    last = torch.full((r_count, 3), float(np.finfo(np.float32).max),
                      dtype=torch.float32).to(dtype)
    pi = float(F32(math.pi))
    two_pi = float(F32(math.pi) * F32(2.0))
    for t in range(t_count):
        d = poses[t, :, :2] - last[:, :2]
        far = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) \
            > p.dist_thresh
        a = poses[t, :, 2] - last[:, 2]
        a = torch.where(a > pi, a - two_pi, a)
        a = torch.where(a < -pi, a + two_pi, a)
        g = far | (a.abs() > p.angle_thresh)
        out[t] = g
        last = torch.where(g[:, None], poses[t], last)
    return out
