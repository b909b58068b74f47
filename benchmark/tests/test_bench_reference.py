"""The reference's equations on cases small enough to check by hand."""

import math

import torch

from benchmark.reference import slam_ref
from benchmark.tests import tiny

P = slam_ref.params(tiny.tiny_cell("live40.tutorial-2048x2").config)
F64 = torch.float64


def test_interp_by_hand():
    prob = torch.zeros((1, 4, 4), dtype=F64)
    prob[0, 1, 1], prob[0, 1, 2] = 0.2, 0.6      # P00, P10 of cell (1, 1)
    prob[0, 2, 1], prob[0, 2, 2] = 0.4, 1.0      # P01, P11
    which = torch.zeros(1, dtype=torch.int64)
    x = torch.tensor([[1.25]], dtype=F64)
    y = torch.tensor([[1.5]], dtype=F64)
    m, gx, gy = slam_ref.interp(prob, which, x, y)
    # value: ((0.2*.75 + 0.6*.25)*.5 + (0.4*.75 + 1.0*.25)*.5) = 0.425
    assert math.isclose(float(m), 0.425)
    # the quirk gradients: -((P00-P10)(1-fx) + (P01-P11) fx), likewise y
    assert math.isclose(float(gx), -((0.2 - 0.6) * 0.75 + (0.4 - 1.0) * 0.25))
    assert math.isclose(float(gy), -((0.2 - 0.4) * 0.5 + (0.6 - 1.0) * 0.5))
    # x > W - 2 is out of bounds and reads zeros
    out = slam_ref.interp(prob, which, torch.tensor([[2.5]], dtype=F64), y)
    assert all(float(v) == 0.0 for v in out)


def test_update_one_beam_by_hand():
    maps = slam_ref.init_maps(P, 1, "cpu", F64)
    # a beam 4 cells along +x from the map's centre cell (128, 128)
    pts = torch.tensor([[[4.0, 0.0]]], dtype=F64)
    slam_ref.update(P, maps, torch.zeros(1, dtype=torch.int64),
                    torch.zeros((1, 3), dtype=F64), pts,
                    torch.zeros((1, 2), dtype=F64),
                    torch.tensor([[True]]))
    lo = maps[0][0]
    assert torch.allclose(lo[128, 128:132],
                          torch.full((4,), P.log_odds_free, dtype=F64))
    assert float(lo[128, 132]) == P.log_odds_occupied
    assert int((lo != 0).sum()) == 5
    assert math.isclose(P.log_odds_free, math.log(0.4 / 0.6), rel_tol=1e-6)
    # level 1 sees the beam at half scale: 2 free cells and the end cell
    assert int((maps[1][0] != 0).sum()) == 3


def test_occupied_wins_within_a_scan():
    maps = slam_ref.init_maps(P, 1, "cpu", F64)
    # the second beam ends on a cell the first one passes through
    pts = torch.tensor([[[6.0, 0.0], [3.0, 0.0]]], dtype=F64)
    slam_ref.update(P, maps, torch.zeros(1, dtype=torch.int64),
                    torch.zeros((1, 3), dtype=F64), pts,
                    torch.zeros((1, 2), dtype=F64),
                    torch.tensor([[True, True]]))
    assert float(maps[0][0, 128, 131]) == P.log_odds_occupied


def test_gates_by_hand():
    poses = torch.tensor([[[0.0, 0.0, 0.0]], [[0.3, 0.0, 0.0]],
                          [[0.41, 0.0, 0.0]], [[0.42, 0.0, 0.1]],
                          [[0.43, 0.0, 0.1]]], dtype=F64)
    # the first scan always updates; then 0.4 m or 0.06 rad from the last
    # update
    assert slam_ref.gates(P, poses)[:, 0].tolist() == [True, False, True,
                                                      True, False]


def test_normalize_angle():
    a = torch.tensor([0.5, 3.5, -3.5, 7.0], dtype=F64)
    n = slam_ref.normalize_angle(a)
    assert torch.allclose(torch.cos(n), torch.cos(a))
    assert bool((n > -math.pi).all() and (n <= math.pi).all())


def test_match_finds_the_pose_it_mapped():
    # a map of one scan of a square room at the origin (0.1 m cells);
    # matching the same scan from 6.4 cm and 0.03 rad off comes back to
    # within 2 mm and 5 mrad
    ang = torch.linspace(-2.3, 2.3, 181, dtype=F64)
    r = torch.minimum(3.0 / torch.cos(ang).abs().clamp(min=1e-9),
                      3.0 / torch.sin(ang).abs().clamp(min=1e-9))
    pts = torch.stack([torch.cos(ang) * r, torch.sin(ang) * r], -1) * 10.0
    mask = torch.ones(181, dtype=torch.bool)
    maps = slam_ref.init_maps(P, 1, "cpu", F64)
    zero = torch.zeros(1, dtype=torch.int64)
    for _ in range(3):
        slam_ref.update(P, maps, zero, torch.zeros((1, 3), dtype=F64),
                        pts[None], torch.zeros((1, 2), dtype=F64), mask[None])
    probs = [slam_ref.probabilities(m) for m in maps]
    start = torch.tensor([[0.05, -0.04, 0.03]], dtype=F64)
    pose = slam_ref.match(P, probs, zero, start, pts, mask)
    assert float(pose[0, :2].norm()) < 2e-3
    assert abs(float(pose[0, 2])) < 5e-3
    # an empty scan returns its start
    none = slam_ref.match(P, probs, zero, start, pts, mask & False)
    assert torch.equal(none, start)
