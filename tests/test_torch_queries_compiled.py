"""The two query entry points compiled as the JAX package compiles them:
``match_pyramid_debug_jit`` (hector_slam_tpu/core/debug.py:98, in
``__all__``) and ``sigma_point_covariance_jit``
(hector_slam_tpu/core/covariance.py:77, on its module only).

On CPU tensors each runs its body eagerly: held here to JAX's jitted
functions on the same inputs within the tolerances of
tests/test_torch_queries.py (covariance within 1e-5 of max|cov|, debug
pose within 1e-4 m, each iteration's Hessian within 1e-5 of its max|H|,
determinants within 1e-4 relative, condition numbers within 1e-3, on
that file's debug input; the final iteration's on every pose of the
room). The
graph path is driven on the CPU with the capture stand-in of
tests/test_torch_graphs_replay.py: one capture per static signature,
then replays with new poses and scans, bit-equal to the eager functions,
the map held (its memory in the key) and nothing donated. The bodies
read nothing on the host (the guard of tests/test_torch_graphs.py)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hector_slam_tpu.core import covariance as jcov
from hector_slam_tpu.core.debug import match_pyramid_debug_jit as j_debug

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import covariance as tcov
from hector_slam_tpu_torch.core import graphs
from hector_slam_tpu_torch.core.debug import match_pyramid_debug
from hector_slam_tpu_torch.core.grid import world_to_map_pose
from hector_slam_tpu_torch.core.interp import quad_pack_storage
from hector_slam_tpu_torch.io.simulator import World, simulate_trajectory
from test_torch_graphs import no_host_reads
from test_torch_graphs_replay import as_on_card  # noqa: F401 (fixture)
from test_torch_queries import (JCFG, TCFG, TL, T, _assert_diag_close,
                                _mapped, _scan_pair)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def room():
    """tests/test_torch_queries.py's mapped room (10 poses), the scans of
    its poses, and the debug test's scan of the last pose."""
    state, levels, poses, _ = _mapped(World.room(size=10.0), 10)
    ranges = simulate_trajectory(World.room(size=10.0), poses, TL)
    last = simulate_trajectory(World.room(size=10.0), poses[-1:], TL)[0]
    return (state, levels, poses, [_scan_pair(r) for r in ranges],
            _scan_pair(last))


def _map_pose(pose):
    return world_to_map_pose(T(pose), TCFG.map.top_left_offset,
                             TCFG.map.level_scale(0))


def _debug_inputs(poses, i):
    return T(poses[i] + np.asarray([0.04, -0.03, 0.02], np.float32))


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(a.numpy() - b).max() / np.abs(b).max())


def test_debug_jit_matches_jax_jit(room):
    """The debug test's input (tests/test_torch_queries.py): every bar of
    that file against JAX's ``match_pyramid_debug_jit``. Every pose of the
    room: the matched pose within 1e-4 m, the final Hessian within 1e-5
    of max|H| and its determinant within 1e-4 relative. (The
    intermediate iterations' Hessians of 5 of the 10 poses read up to
    3.3e-3 of max|H| apart: where a beam ends within f32 rounding of a
    cell edge, the two packages' iterates, 1e-7 m apart, take different
    sides of the bilinear gradient's step.)"""
    state, levels, poses, scans, (js, ts) = room
    start = _debug_inputs(poses, -1)
    pose, hess, diag = ht.match_pyramid_debug_jit(levels, start, ts, TCFG)
    jpose, jhess, jdiag = j_debug(state.log_odds, jnp.asarray(start.numpy()),
                                  js, JCFG)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-4)
    assert torch.equal(diag.hessian[-1], hess)
    _assert_diag_close(diag, {k: np.asarray(v)
                              for k, v in jdiag._asdict().items()})
    for i, (js, ts) in enumerate(scans):
        start = _debug_inputs(poses, i)
        pose, hess, diag = ht.match_pyramid_debug_jit(levels, start, ts,
                                                      TCFG)
        jpose, jhess, jdiag = j_debug(state.log_odds,
                                      jnp.asarray(start.numpy()), js, JCFG)
        np.testing.assert_allclose(pose.numpy(), np.asarray(jpose),
                                   atol=1e-4)
        assert _rel(hess, jhess) <= 1e-5
        assert _rel(diag.determinant[-1:], jdiag.determinant[-1:]) <= 1e-4
        # the body is the eager function, bit for bit
        want = match_pyramid_debug(levels, start, ts, TCFG)
        assert torch.equal(pose, want[0]) and torch.equal(hess, want[1])


def test_covariance_jit_matches_jax_jit(room):
    state, levels, poses, scans, _ = room
    for i, (js, ts) in enumerate(scans):
        pm = _map_pose(poses[i])
        cov = tcov.sigma_point_covariance_jit(levels[0], pm, ts).numpy()
        want = np.asarray(jcov.sigma_point_covariance_jit(
            state.log_odds[0], jnp.asarray(pm.numpy()), js))
        assert np.abs(cov - want).max() <= 1e-5 * np.abs(want).max()
        np.testing.assert_array_equal(cov, cov.T)
        np.testing.assert_array_equal(
            cov, tcov.sigma_point_covariance(levels[0], pm, ts).numpy())


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_equal(x, y) for x, y in zip(a, b))


def test_query_graphs_replay_bit_equal_to_eager(as_on_card, room):
    """One capture per signature (the debug match with and without the
    quads, the covariance), then replays with each pose and scan: every
    result bit-equal to the eager function's, fresh tensors that the next
    replay does not overwrite, and the map unchanged."""
    _, levels, poses, scans, _ = room
    scans = scans[-3:]
    quads = [quad_pack_storage(lo, TCFG.update.cell_model) for lo in levels]
    before = [lo.clone() for lo in levels]
    kept = []
    for i, (_, ts) in enumerate(scans):
        start = _debug_inputs(poses, -3 + i)
        for q in (None, quads):
            got = ht.match_pyramid_debug_jit(levels, start, ts, TCFG,
                                             quads=q)
            assert _equal(got, match_pyramid_debug(levels, start, ts, TCFG,
                                                   quads=q))
            kept.append((got, match_pyramid_debug(levels, start, ts, TCFG,
                                                  quads=q)))
        pm = _map_pose(poses[-3 + i])
        cov = tcov.sigma_point_covariance_jit(levels[0], pm, ts)
        assert torch.equal(cov, tcov.sigma_point_covariance(levels[0], pm,
                                                            ts))
        kept.append((cov, cov.clone()))
    assert all(_equal(a, b) for a, b in kept)
    assert all(torch.equal(a, b) for a, b in zip(levels, before))
    stats = {s.name: s for s in graphs.stats()}
    assert graphs.totals()["captures"] >= 3
    assert len([s for s in graphs.stats()
                if s.name == "match_pyramid_debug_jit"]) == 2
    assert stats["match_pyramid_debug_jit"].replays == len(scans)
    assert stats["sigma_point_covariance_jit"].replays == len(scans)


# torch ops that read the card on the host inside C++, where the guard of
# tests/test_torch_graphs.py cannot see it: the solvers read their status
# (``info``), and ops with data-dependent shapes read their sizes
SYNCING_OPS = ((torch.linalg, ("eigvalsh", "eigh", "eig", "det", "slogdet",
                               "inv", "solve", "cholesky", "lstsq", "svd",
                               "svdvals", "lu_factor")),
               (torch, ("nonzero", "masked_select", "unique", "argwhere")),
               (torch.Tensor, ("nonzero", "masked_select", "unique")))


@contextlib.contextmanager
def no_syncing_ops():
    """Within: each op of SYNCING_OPS raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("an op that reads the card on the host")

    with pytest.MonkeyPatch.context() as mp:
        for owner, names in SYNCING_OPS:
            for name in names:
                mp.setattr(owner, name, refuse)
        yield


def test_query_bodies_make_no_host_round_trip(room):
    """Neither body reads the card on the host: not through a tensor's
    Python methods (the guard of tests/test_torch_graphs.py) and not
    through an op that does it in C++ (a solver's status check: the
    debug match's condition numbers are closed-form, where
    ``torch.linalg.eigvalsh`` would read its status and refuse the
    capture)."""
    _, levels, poses, scans, _ = room
    _, ts = scans[0]
    start, pm = _debug_inputs(poses, 0), _map_pose(poses[0])

    def bodies():
        yield match_pyramid_debug(levels, start, ts, TCFG)
        yield tcov.sigma_point_covariance(levels[0], pm, ts)

    warm = list(bodies())
    with no_host_reads(), no_syncing_ops():
        again = list(bodies())
        with pytest.raises(AssertionError, match="on the host"):
            torch.linalg.eigvalsh(warm[0][1])   # the control
    assert all(_equal(a, b) for a, b in zip(warm, again))
