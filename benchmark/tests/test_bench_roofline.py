"""The roofline's work counts against counts made by hand."""

import torch

from benchmark.reference import slam_ref
from benchmark.roofline import formulas
from benchmark.tests import tiny

P = slam_ref.params(tiny.tiny_cell("live40.tutorial-2048x2").config)


def test_match_work_by_hand():
    # two beams, both in the map at every step, one masked beam: per GN
    # step 2 used queries; levels 1 and 0 run 3+1 and 5+1 steps
    pts = torch.tensor([[10.0, 0.0], [0.0, 10.0], [5.0, 5.0]])
    mask = torch.tensor([True, True, False])
    starts = torch.zeros((1, 3))
    true = torch.zeros(3)
    m_ops, m_bytes, x_ops, x_bytes = formulas.match_work(P, starts, true,
                                                         pts, mask)
    steps = 4 + 6
    assert m_ops == 53 * 2 * steps
    # every step reads two distinct quads (16 bytes), the hypothesis's 60
    # bytes and the three beams' 9 bytes
    assert m_bytes == steps * (2 * 16 + 60 + 3 * 9)
    assert x_ops == m_ops + 48 * steps
    assert x_bytes == m_bytes + 24 * 2


def test_queries_out_of_the_map_count_8_operations():
    pts = torch.tensor([[1e6, 0.0]])
    mask = torch.tensor([True])
    m_ops, m_bytes, _, _ = formulas.match_work(P, torch.zeros((2, 3)),
                                               torch.zeros(3), pts, mask)
    assert m_ops == 8 * 2 * 10
    assert m_bytes == 10 * (2 * 60 + 9)


def test_least_s_by_hand():
    # a second of the peak's bytes, or of its operations
    assert formulas.least_s(0.0, 3.35e12) == 1.0
    assert formulas.least_s(67e12, 0.0) == 1.0
    assert formulas.least_s(67e12, 2 * 3.35e12) == 2.0
