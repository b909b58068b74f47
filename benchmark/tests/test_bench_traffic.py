"""The generator: one seed, one traffic; another seed, other traffic of
the same amount; the raycast and the laser conversion by hand."""

import math

import numpy as np
import torch

from benchmark.sim import traffic, world
from benchmark.tests import tiny

CFG = tiny.tiny_cell("live40.tutorial-2048x2")


def laps(seed):
    return traffic.make_laps(CFG.traffic, CFG.config["laser"], 3, seed,
                             "cpu")


def test_same_seed_same_traffic():
    a, b = laps(2 ** 31 + 11), laps(2 ** 31 + 11)
    assert np.array_equal(a.poses, b.poses)
    assert torch.equal(a.ranges, b.ranges)


def test_other_seed_other_traffic_of_the_same_size():
    a, b = laps(2 ** 31 + 11), laps(2 ** 31 + 12)
    assert a.poses.shape == b.poses.shape
    assert a.ranges.shape == b.ranges.shape
    assert not np.array_equal(a.poses, b.poses)
    assert not torch.equal(a.ranges, b.ranges)
    # every lap starts at the SLAM frame's origin and closes on itself
    for lap in (a, b):
        assert np.abs(lap.poses[:, 0]).max() < 1e-12
        step = np.linalg.norm(np.diff(lap.poses[:, :, :2], axis=1), axis=-1)
        wrap = np.linalg.norm(lap.poses[:, 0, :2] - lap.poses[:, -1, :2],
                              axis=-1)
        assert np.allclose(wrap, step.mean(axis=1), rtol=1e-6)


def test_raycast_by_hand():
    # a robot at the centre of a 4 m square room, facing +x: the beam at 0
    # hits the wall 2 m ahead, the one at 90 degrees 2 m to the left, and
    # one at 45 degrees the corner at 2*sqrt(2)
    segs = torch.tensor([[[-2.0, -2.0, 2.0, -2.0], [2.0, -2.0, 2.0, 2.0],
                          [2.0, 2.0, -2.0, 2.0], [-2.0, 2.0, -2.0, -2.0]]],
                        dtype=torch.float64)
    poses = torch.zeros((1, 1, 3), dtype=torch.float64)
    ang = torch.tensor([0.0, math.pi / 2, math.pi / 4 - 1e-9],
                       dtype=torch.float64)
    r = world.raycast(segs, poses, ang, 0.1, 30.0)[0, 0]
    assert torch.allclose(r.double(), torch.tensor(
        [2.0, 2.0, 2.0 * math.sqrt(2.0)], dtype=torch.float64), atol=1e-6)
    # nothing to hit: the laser's maximum range
    far = world.raycast(segs[:, :1], poses, ang[1:2], 0.1, 30.0)
    assert float(far) == 30.0


def test_scans_from_ranges_by_hand():
    laser = dict(num_beams=4, angle_min=0.0, angle_increment=math.pi / 2,
                 range_min=0.1, range_max=30.0)
    ranges = torch.tensor([1.0, 0.05, 30.0, 2.0])   # too short, too long
    pts, mask = traffic.scans_from_ranges(ranges, laser, 20.0, 6)
    assert mask.tolist() == [True, True, False, False, False, False]
    assert torch.allclose(pts[0], torch.tensor([20.0, 0.0]))
    assert torch.allclose(pts[1], torch.tensor([0.0, -40.0]), atol=1e-4)
    assert torch.all(pts[2:] == 0)
