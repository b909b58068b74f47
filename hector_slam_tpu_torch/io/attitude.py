"""Attitude utilities — the hector_imu_attitude_to_tf and hector_imu_tools
equivalents (src/imu_attitude_to_tf_node.cpp:45-59,
src/pose_and_orientation_to_imu_node.cpp:65-159) without ROS/tf: pure
quaternion math for fusing the planar SLAM yaw with IMU roll/pitch.

A numpy copy of ``hector_slam_tpu/io/attitude.py`` (the port imports
nothing of the JAX package); quaternions, poses and positions may be
numpy arrays, sequences or tensors on any device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..types import host_array


def quaternion_to_rpy(q) -> Tuple[float, float, float]:
    """(roll, pitch, yaw) from (x, y, z, w), ZYX convention (matches
    tf::Matrix3x3::getRPY used by the reference nodes)."""
    x, y, z, w = (float(v) for v in host_array(q))
    roll = np.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    sinp = 2.0 * (w * y - z * x)
    pitch = np.arcsin(np.clip(sinp, -1.0, 1.0))
    yaw = np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return float(roll), float(pitch), float(yaw)


def rpy_to_quaternion(roll: float, pitch: float,
                      yaw: float) -> Tuple[float, float, float, float]:
    """(x, y, z, w) from ZYX Euler angles."""
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return (
        float(sr * cp * cy - cr * sp * sy),
        float(cr * sp * cy + sr * cp * sy),
        float(cr * cp * sy - sr * sp * cy),
        float(cr * cp * cy + sr * sp * sy),
    )


def attitude_to_stabilized_transform(imu_quat):
    """base_stabilized -> base_link rotation: roll/pitch only, yaw
    dropped (imu_attitude_to_tf_node.cpp:45-59)."""
    roll, pitch, _ = quaternion_to_rpy(imu_quat)
    return rpy_to_quaternion(roll, pitch, 0.0)


def fuse_pose_and_attitude(slam_pose, imu_quat):
    """Fused orientation: SLAM yaw + IMU roll/pitch
    (pose_and_orientation_to_imu_node.cpp:100-120). Returns (x,y,z,w)."""
    roll, pitch, _ = quaternion_to_rpy(imu_quat)
    return rpy_to_quaternion(roll, pitch, float(host_array(slam_pose)[2]))


class ImuPoseFuser:
    """The full hector_imu_tools node state machine
    (pose_and_orientation_to_imu_node.cpp:65-159) — not just the
    quaternion fusion: per-IMU-message fused attitude, the 1-in-5
    decimated odometry product (/state), and the
    map->base_footprint->base_stabilized transform chain the node
    broadcasts per pose message.
    """

    def __init__(self, odom_decimation: int = 5):
        # (callback_count_ % 5) == 0 gate (:109-117)
        self.odom_decimation = odom_decimation
        self._callback_count = 0
        self._last_pose = None          # (position xyz, yaw)
        self._fused_quat = (0.0, 0.0, 0.0, 1.0)

    def on_pose(self, position, yaw: float, stamp: float = 0.0):
        """SLAM pose input (poseMsgCallback :121-159). Returns the two
        stamped transforms the node broadcasts: map->base_footprint (the
        full planar pose) and base_footprint->base_stabilized (identity
        rotation, zero height — the node's height_transform)."""
        position = tuple(float(v) for v in host_array(position))
        if len(position) == 2:
            position = position + (0.0,)
        self._last_pose = (position, float(yaw))
        quat = rpy_to_quaternion(0.0, 0.0, float(yaw))
        return (
            {"parent": "map", "child": "base_footprint", "stamp": stamp,
             "translation": position, "rotation": quat},
            {"parent": "base_footprint", "child": "base_stabilized",
             "stamp": stamp, "translation": (0.0, 0.0, 0.0),
             "rotation": (0.0, 0.0, 0.0, 1.0)},
        )

    def on_imu(self, imu_quat, stamp: float = 0.0):
        """IMU input (imuMsgCallback :85-118). Returns
        (fused_imu, odometry-or-None): fused_imu is the IMU roll/pitch
        recombined with the last SLAM yaw (yaw 0 before any pose, as the
        node does); odometry fires on every ``odom_decimation``-th IMU
        message once a pose has arrived, carrying the fused orientation
        and the last pose position."""
        yaw = self._last_pose[1] if self._last_pose is not None else 0.0
        roll, pitch, _ = quaternion_to_rpy(imu_quat)
        self._fused_quat = rpy_to_quaternion(roll, pitch, yaw)
        fused = {"stamp": stamp, "orientation": self._fused_quat}
        odom = None
        if (self._last_pose is not None
                and self._callback_count % self.odom_decimation == 0):
            odom = {"stamp": stamp, "orientation": self._fused_quat,
                    "position": self._last_pose[0]}
        self._callback_count += 1
        return fused, odom
