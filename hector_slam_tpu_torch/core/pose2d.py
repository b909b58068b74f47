"""2D pose algebra — the tf-frame bookkeeping of the reference node
(map->odom and map->scanmatcher_frame publishing,
src/HectorMappingRos.cpp:359-380) reduced to pure functions on (x, y,
theta) triples.

A numpy copy of ``hector_slam_tpu/core/pose2d.py``
(the port imports nothing of the JAX package); it takes numpy
arrays, and the session hands it host copies of its tensors.
"""

from __future__ import annotations

import numpy as np


def compose(a, b) -> np.ndarray:
    """T_a compose T_b: apply b in a's frame (tf multiplication)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.asarray([
        a[0] + c * b[0] - s * b[1],
        a[1] + s * b[0] + c * b[1],
        a[2] + b[2],
    ], np.float64)


def invert(p) -> np.ndarray:
    p = np.asarray(p, np.float64)
    c, s = np.cos(p[2]), np.sin(p[2])
    return np.asarray([
        -(c * p[0] + s * p[1]),
        -(-s * p[0] + c * p[1]),
        -p[2],
    ], np.float64)


def map_to_odom(map_base: np.ndarray, odom_base: np.ndarray) -> np.ndarray:
    """The node's map->odom transform: T_map_odom = T_map_base *
    T_odom_base^-1 (HectorMappingRos.cpp:359-374)."""
    return compose(np.asarray(map_base, np.float64),
                   invert(np.asarray(odom_base, np.float64)))


def transform_point(pose, xy) -> np.ndarray:
    pose = np.asarray(pose, np.float64)
    xy = np.asarray(xy, np.float64)
    c, s = np.cos(pose[2]), np.sin(pose[2])
    return np.asarray([pose[0] + c * xy[0] - s * xy[1],
                       pose[1] + s * xy[0] + c * xy[1]], np.float64)


def map_to_odom_transform(slam_pose, odom_to_base):
    """SE(2) transform map->odom = T(slam_pose) * T(odom_to_base)^-1 —
    the reference's map->odom tf output (HectorMappingRos.cpp:359-374:
    ``poseInfoContainer_.getTfTransform() * odom_to_base.inverse()``).
    Both inputs and the result are (x, y, yaw) triples."""
    import numpy as np
    px, py, pt = (float(v) for v in slam_pose[:3])
    ox, oy, ot = (float(v) for v in odom_to_base[:3])
    # inverse of odom->base
    ci, si = np.cos(-ot), np.sin(-ot)
    ix = -(ci * ox - si * oy)
    iy = -(si * ox + ci * oy)
    # compose T(pose) * T(inv)
    c, s = np.cos(pt), np.sin(pt)
    return np.asarray([
        px + c * ix - s * iy,
        py + s * ix + c * iy,
        pt - ot,
    ], np.float32)
