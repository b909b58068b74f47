"""Trajectory recording and recovery queries — the hector_trajectory_server
equivalent (src/hector_trajectory_server.cpp) without ROS: the caller
appends poses; queries are plain functions.

A numpy copy of ``hector_slam_tpu/export/trajectory.py``
(the port imports nothing of the JAX package); it takes numpy
arrays, and the session hands it host copies of its tensors.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RecoveryInfo:
    """GetRecoveryInfo result (hector_trajectory_server.cpp:172-238)."""

    req_pose: np.ndarray            # pose at/after the request time
    radius_entry_pose: np.ndarray   # first pose outside the radius, walking
    #                                 backwards from req_pose
    trajectory: np.ndarray          # poses from req_pose back to entry pose
    #                                 (reverse chronological, exclusive of
    #                                 the entry pose — reference loop bound)


class TrajectoryRecorder:
    """Accumulates (stamp, pose) pairs; dedups identical stamps
    (hector_trajectory_server.cpp:124-141)."""

    def __init__(self):
        self.stamps: List[float] = []
        self.poses: List[np.ndarray] = []

    def add(self, stamp: float, pose) -> None:
        pose = np.asarray(pose, np.float32)
        if self.stamps and self.stamps[-1] == stamp:
            return  # only add if not already stored for this stamp
        self.stamps.append(float(stamp))
        self.poses.append(pose)

    def reset(self) -> None:
        """syscommand "reset" (hector_trajectory_server.cpp:114-122)."""
        self.stamps.clear()
        self.poses.clear()

    def path(self) -> np.ndarray:
        """nav_msgs/Path equivalent: f32[T, 3]."""
        if not self.poses:
            return np.zeros((0, 3), np.float32)
        return np.stack(self.poses)

    def recovery_info(self, request_time: float,
                      request_radius: float) -> Optional[RecoveryInfo]:
        """Walks the trajectory backwards from the pose at request_time
        until leaving the radius (hector_trajectory_server.cpp:172-238).
        Returns None when the whole stored trajectory stays inside the
        radius (the reference returns failure)."""
        if not self.poses:
            return None
        # lower_bound by stamp; if past the end, use the latest pose
        i_start = bisect.bisect_left(self.stamps, request_time)
        if i_start >= len(self.poses):
            i_start = len(self.poses) - 1
        req_pose = self.poses[i_start]
        req_xy = req_pose[:2]
        thresh_sqr = float(request_radius) ** 2

        i = i_start
        dist_sqr = 0.0
        while i > 0 and dist_sqr < thresh_sqr:
            cur = self.poses[i][:2]
            dist_sqr = float(np.sum((req_xy - cur) ** 2))
            i -= 1
        if dist_sqr < thresh_sqr:
            return None
        i_end = i
        # reference copies poses from it_start down to (but excluding)
        # it_end, reverse chronological
        traj = np.stack([self.poses[j]
                         for j in range(i_start, i_end, -1)])
        return RecoveryInfo(req_pose=req_pose,
                            radius_entry_pose=self.poses[i_end],
                            trajectory=traj)
