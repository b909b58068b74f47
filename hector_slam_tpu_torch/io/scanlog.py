"""Scan construction and scan-log IO.

Counterpart of ``hector_slam_tpu/io/scanlog.py``: the same numpy
conversions (HectorMappingRos::rosLaserScanToDataContainer and
rosPointCloudToDataContainer, src/HectorMappingRos.cpp:483-542) and the
same .npz scan-log format, returning tensors on the chosen device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import Scan, resolve_device


@dataclasses.dataclass(frozen=True)
class LaserModel:
    """Hokuyo UTM-30LX geometry (the reference's headline sensor,
    hector_mapping/package.xml:7): 1081 beams over 270 deg at 40 Hz."""

    num_beams: int = 1081
    angle_min: float = -2.356194490192345   # -135 deg
    angle_increment: float = 0.004363323129985824  # 0.25 deg
    range_min: float = 0.1
    range_max: float = 30.0

    @property
    def angles(self) -> np.ndarray:
        return (self.angle_min
                + np.arange(self.num_beams) * self.angle_increment
                ).astype(np.float32)


def scan_from_ranges(
    ranges: np.ndarray,
    scale_to_map: float,
    laser: LaserModel = LaserModel(),
    max_beams: int = 1152,
    origo: Tuple[float, float] = (0.0, 0.0),
    device="cuda",
) -> Scan:
    """Polar ranges -> padded Scan (keep beams with range in
    (range_min, range_max - 0.1), endpoints cos/sin * range * scaleToMap)
    on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    ranges = np.asarray(ranges, np.float32)
    angles = laser.angles[: len(ranges)]
    max_range = np.float32(laser.range_max - 0.1)
    keep = (ranges > np.float32(laser.range_min)) & (ranges < max_range)
    dist = ranges[keep] * np.float32(scale_to_map)
    pts = np.stack([np.cos(angles[keep]) * dist,
                    np.sin(angles[keep]) * dist], axis=-1).astype(np.float32)
    return _pad(pts, origo, max_beams, dev)


def beam_directions(laser: LaserModel, num_beams: int,
                    device="cuda") -> torch.Tensor:
    """f32[num_beams, 2]: (cos, sin) of the laser's first ``num_beams``
    beam angles, computed by numpy as ``scan_from_ranges`` computes them,
    on ``device``: the constant that ``scans_from_ranges`` takes."""
    ang = laser.angles[:num_beams]
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1)
                            .astype(np.float32)).to(resolve_device(device))


def scans_from_ranges(
    ranges: torch.Tensor,
    directions: torch.Tensor,
    scale_to_map: float,
    laser: LaserModel = LaserModel(),
    max_beams: int = 1152,
) -> Scan:
    """``scan_from_ranges`` of R scans at once on the ranges' device, with
    no host read: ranges f32[R, B] and ``beam_directions(laser, B)`` in, a
    Scan with points [R, max_beams, 2], origo [R, 2] and mask
    [R, max_beams] out, each robot's bit-equal to ``scan_from_ranges`` of
    its row. The kept beams move to the front in beam order by a
    scatter through their running count (the beams left out go behind
    them and are zeroed), so the result needs no count on the host; a
    scan of more than ``max_beams`` beams is refused by its width."""
    r_count, b = ranges.shape
    if b > max_beams:
        raise ValueError(f"scans have {b} beams > max_beams={max_beams}")
    keep = (ranges > np.float32(laser.range_min)) \
        & (ranges < np.float32(laser.range_max - 0.1))
    pts = directions * (ranges * np.float32(scale_to_map))[..., None]
    kept = torch.cumsum(keep, -1)
    beam = torch.arange(b, device=ranges.device)
    dest = torch.where(keep, kept - 1, kept[:, -1:] + beam - kept)
    out = torch.zeros((r_count, max_beams, 2), dtype=torch.float32,
                      device=ranges.device)
    out.scatter_(1, dest[..., None].expand(r_count, b, 2), pts)
    mask = torch.arange(max_beams, device=ranges.device) < kept[:, -1:]
    return Scan(points=torch.where(mask[..., None], out, 0.0),
                origo=torch.zeros((r_count, 2), dtype=torch.float32,
                                  device=ranges.device),
                mask=mask)


def scan_from_points(
    points_base: np.ndarray,
    scale_to_map: float,
    max_beams: int = 1152,
    origo_base: Tuple[float, float] = (0.0, 0.0),
    min_dist: float = 0.4,
    max_dist: float = 30.0,
    device="cuda",
) -> Scan:
    """Cartesian base-frame points -> padded Scan on ``device`` (the
    rosPointCloudToDataContainer path: range^2 window filter plus the
    behind-robot rejection x<0 and dist^2<0.5,
    HectorMappingRos.cpp:524-531). Points and origo are scaled to map
    units."""
    dev = resolve_device(device)
    pts = np.asarray(points_base, np.float32)
    d2 = pts[:, 0] ** 2 + pts[:, 1] ** 2
    keep = (d2 > np.float32(min_dist) ** 2) & (d2 < np.float32(max_dist) ** 2)
    keep &= ~((pts[:, 0] < 0.0) & (d2 < np.float32(0.5)))
    pts = (pts[keep] * np.float32(scale_to_map)).astype(np.float32)
    origo = np.asarray(origo_base, np.float32) * np.float32(scale_to_map)
    return _pad(pts, origo, max_beams, dev)


def _pad(points: np.ndarray, origo, max_beams: int, device) -> Scan:
    n = len(points)
    if n > max_beams:
        raise ValueError(f"scan has {n} beams > max_beams={max_beams}")
    padded = np.zeros((max_beams, 2), np.float32)
    padded[:n] = points
    mask = np.zeros(max_beams, bool)
    mask[:n] = True
    return Scan(points=torch.from_numpy(padded).to(device),
                origo=torch.from_numpy(
                    np.asarray(origo, np.float32).copy()).to(device),
                mask=torch.from_numpy(mask).to(device))


def stack_scans(scans: Sequence[Scan]) -> Scan:
    """Stack per-scan tuples into one Scan with a leading time axis, for
    ``run_log``."""
    return Scan(points=torch.stack([s.points for s in scans]),
                origo=torch.stack([s.origo for s in scans]),
                mask=torch.stack([s.mask for s in scans]))


def save_log(path: str, ranges: np.ndarray, poses_true: Optional[np.ndarray]
             = None, laser: LaserModel = LaserModel()) -> None:
    """Persist a scan log: ranges f32[T, B] plus optional ground truth."""
    data = dict(
        ranges=np.asarray(ranges, np.float32),
        num_beams=laser.num_beams, angle_min=laser.angle_min,
        angle_increment=laser.angle_increment,
        range_min=laser.range_min, range_max=laser.range_max,
    )
    if poses_true is not None:
        data["poses_true"] = np.asarray(poses_true, np.float32)
    np.savez_compressed(path, **data)


def load_log(path: str):
    """Returns (ranges f32[T,B], LaserModel, poses_true or None)."""
    with np.load(path) as z:
        laser = LaserModel(
            num_beams=int(z["num_beams"]), angle_min=float(z["angle_min"]),
            angle_increment=float(z["angle_increment"]),
            range_min=float(z["range_min"]), range_max=float(z["range_max"]))
        poses = z["poses_true"] if "poses_true" in z else None
        return z["ranges"], laser, poses
