"""Pose/covariance output formatting — the PoseInfoContainer equivalent
(hector_mapping/src/PoseInfoContainer.cpp): planar pose -> quaternion and
the 3x3 scan-match "covariance" (raw Hessian, ScanMatcher.h:184) embedded
into a 6x6 row-major covariance at the (x, y, yaw) slots.

A numpy copy of ``hector_slam_tpu/export/pose_output.py``
(the port imports nothing of the JAX package); it takes numpy
arrays, and the session hands it host copies of its tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def yaw_to_quaternion(yaw: float) -> Tuple[float, float, float, float]:
    """(x, y, z, w) with only the planar rotation set
    (PoseInfoContainer.cpp:42-43)."""
    return (0.0, 0.0, float(np.sin(np.float32(yaw) * np.float32(0.5))),
            float(np.cos(np.float32(yaw) * np.float32(0.5))))


def quaternion_to_yaw(q) -> float:
    """tf::getYaw equivalent for a planar quaternion (x,y,z,w)."""
    x, y, z, w = (float(v) for v in q)
    return float(np.arctan2(2.0 * (w * z + x * y),
                            1.0 - 2.0 * (y * y + z * z)))


def covariance_6x6(slam_cov: np.ndarray) -> np.ndarray:
    """Row-major 6x6 (x, y, z, rot_x, rot_y, rot_z) with the 3x3 planar
    covariance at {x, y, yaw} (PoseInfoContainer.cpp:50-66)."""
    c = np.asarray(slam_cov, np.float64)
    out = np.zeros((6, 6), np.float64)
    out[0, 0] = c[0, 0]
    out[1, 1] = c[1, 1]
    out[5, 5] = c[2, 2]
    out[0, 1] = out[1, 0] = c[0, 1]
    out[0, 5] = out[5, 0] = c[0, 2]
    out[1, 5] = out[5, 1] = c[1, 2]
    return out


def pose_stamped(pose: np.ndarray, cov: np.ndarray, stamp: float) -> dict:
    """A PoseWithCovarianceStamped-shaped dict (frame-free)."""
    q = yaw_to_quaternion(float(pose[2]))
    return {
        "stamp": float(stamp),
        "position": (float(pose[0]), float(pose[1]), 0.0),
        "orientation": q,
        "covariance": covariance_6x6(cov),
    }


def covariance_world_coords(cov_map: np.ndarray,
                            cell_length: float) -> np.ndarray:
    """Scale a map-coordinate 3x3 covariance into world coordinates
    (OccGridMapUtil::getCovMatrixWorldCoords, OccGridMapUtil.h:162-187):
    translation block x cell^2, cross terms x cell, angle untouched."""
    c = np.asarray(cov_map, np.float32)
    s = np.float32(cell_length)
    s2 = s * s
    out = np.empty((3, 3), np.float32)
    out[0, 0] = c[0, 0] * s2
    out[1, 1] = c[1, 1] * s2
    out[1, 0] = out[0, 1] = c[1, 0] * s2
    out[2, 0] = out[0, 2] = c[2, 0] * s
    out[2, 1] = out[1, 2] = c[2, 1] * s
    out[2, 2] = c[2, 2]
    return out
