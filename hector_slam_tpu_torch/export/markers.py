"""Visualization marker helpers — the hector_marker_drawing equivalent.

A numpy copy of ``hector_slam_tpu/export/markers.py`` (the port imports
nothing of the JAX package); it takes numpy arrays or tensors on any
device. The reference renders poses, scan points and covariance ellipses
as rviz markers (hector_marker_drawing/include/hector_marker_drawing/
HectorDrawings.h:68-180). Without ROS there is no marker topic: these
return plain polygon/segment arrays in world coordinates with the same
geometry:

  - ``covariance_ellipse``: the eigendecomposition of the pose
    covariance's 2x2 translation block -> (half-axis lengths, angle), the
    computeEllipseParameters logic (HectorDrawings.h:102-141: eigenvalues
    of [[a,b],[b,c]] in trace/determinant closed form, major-axis angle
    atan2(2b, a-c)/2).
  - ``arrow_marker``: the drawArrow segment set (HectorDrawings.h:84-100).
  - ``pose_markers``: per-pose arrow segments for a trajectory.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..types import host_array


def covariance_ellipse(cov2, n_sigma: float = 1.0, num_points: int = 32
                       ) -> Tuple[np.ndarray, float, np.ndarray]:
    """(half_axes [2], angle, polygon [num_points, 2] centered at 0).

    ``cov2`` is the 2x2 translation block of the pose covariance. The
    closed-form eigenvalues follow HectorDrawings.h:120-128."""
    cov2 = host_array(cov2).astype(np.float64)
    a, b, c = cov2[0, 0], cov2[0, 1], cov2[1, 1]
    tr = a + c
    root = np.sqrt(max((a - c) * (a - c) + 4.0 * b * b, 0.0))
    eig_hi = 0.5 * (tr + root)
    eig_lo = 0.5 * (tr - root)
    angle = 0.5 * np.arctan2(2.0 * b, a - c)
    half = n_sigma * np.sqrt(np.maximum([eig_hi, eig_lo], 0.0))
    t = np.linspace(0.0, 2.0 * np.pi, num_points, endpoint=False)
    unit = np.stack([half[0] * np.cos(t), half[1] * np.sin(t)], -1)
    ca, sa = np.cos(angle), np.sin(angle)
    rot = np.asarray([[ca, -sa], [sa, ca]])
    return half.astype(np.float32), float(angle), \
        (unit @ rot.T).astype(np.float32)


def arrow_marker(pose, length: float = 0.3) -> np.ndarray:
    """Arrow segments [(x0,y0,x1,y1), ...] for one (x, y, yaw) pose
    (drawArrow, HectorDrawings.h:84-100: shaft + two 30-degree barbs)."""
    pose = host_array(pose).astype(np.float64)
    x, y, th = pose[0], pose[1], pose[2]
    tip = np.asarray([x + length * np.cos(th), y + length * np.sin(th)])
    barb = 0.35 * length
    segs = [(x, y, tip[0], tip[1])]
    for off in (np.pi * 5 / 6, -np.pi * 5 / 6):
        segs.append((tip[0], tip[1],
                     tip[0] + barb * np.cos(th + off),
                     tip[1] + barb * np.sin(th + off)))
    return np.asarray(segs, np.float32)


def pose_markers(poses, length: float = 0.3) -> np.ndarray:
    """Stacked arrow segments for a trajectory [T, 3] -> [T*3, 4]."""
    poses = np.atleast_2d(host_array(poses))
    return np.concatenate([arrow_marker(p, length) for p in poses], axis=0)
