"""The session's recoveries through the port's compiled routes
(``cascade_refine_jit``, ``residual_for_poses_jit``, and the matchers'
``*_jit``), on the CPU.

At ``BENCH_CONFIG``, on the JAX session's state after the 435-scan
corridor replay (the JAX checkpoint in
tests/fixtures/queries_jax_reference.npz, carried across with each
package's ``load_state``) kidnapped by (+0.6 m, -0.5 m, +0.25 rad), with
its last scan:
  - ``cascade_refine_jit`` through the graph path (``graphs._capture``
    replaced by the CPU stand-in of tests/test_torch_graphs_replay.py)
    equals ``cascade_refine`` bit for bit, over replays on new
    hypotheses, one capture for the map;
  - ``residual_for_poses_jit`` against JAX's at level 0 and at the
    coarsest level, with and without the quads, on the full scan and on
    the global sweep's 8-strided one: the per-beam terms are the same
    f32 values, but XLA sums them in another order than the port's
    fixed pairwise ``beam_sum``, so the residuals are held within 1e-4
    relative (measured: up to 4.8e-5 at 1,081 beams, where the port's
    sum lies within 1e-6 of the f64 sum of the same terms);
  - the session takes the compiled routes for every method and for the
    global sweep, and the eager names are not on its path.

``cascade_refine_jit`` against JAX's ``cascade_refine_jit(...,
interpret=True)`` runs on tests/test_torch_recovery.py's corridor state
(256^2 x 2 levels): at ``BENCH_CONFIG`` XLA compiles JAX's interpreted
kernel for ~140 s in ~3.3 GB on a CPU. Tolerances there are those of
``test_relocalize_cascade_matches_jax_pallas``: the winner within 5 mm
and 0.005 rad, its residual within 1%."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hector_slam_tpu.config import BENCH_CONFIG as J_BENCH_CONFIG
from hector_slam_tpu.io.checkpoint import load_state as j_load_state
from hector_slam_tpu.parallel import batch as jbatch
from hector_slam_tpu.parallel import recovery as jrec
from hector_slam_tpu.types import Scan as JScan

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch import session as tsession
from hector_slam_tpu_torch.core import graphs
from hector_slam_tpu_torch.parallel import batch as tbatch
from hector_slam_tpu_torch.parallel import recovery as trec
from test_torch_graphs import no_host_reads
from test_torch_graphs_replay import as_on_card  # noqa: F401
from test_torch_recovery import _kidnapped_pair, _yaw_err, corridor  # noqa: F401

REFERENCE = os.path.join(os.path.dirname(__file__), "fixtures",
                         "queries_jax_reference.npz")
MXU_REFERENCE = os.path.join(os.path.dirname(__file__), "fixtures",
                             "mxu_jax_reference.npz")
CFG = ht.BENCH_CONFIG
KIDNAP = np.asarray([0.6, -0.5, 0.25], np.float32)
RESIDUAL_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bench():
    """(JAX state, port state on the CPU, JAX scan, port scan, kidnapped
    pose): the JAX session's state after the corridor replay and its
    last scan, in both packages."""
    with np.load(REFERENCE) as z:
        points, origo, mask = (z[k] for k in ("scan_points", "scan_origo",
                                              "scan_mask"))
    jstate = j_load_state(REFERENCE, J_BENCH_CONFIG)
    state = ht.load_state(REFERENCE, CFG, device="cpu")
    jscan = JScan(jnp.asarray(points), jnp.asarray(origo), jnp.asarray(mask))
    scan = ht.Scan(torch.from_numpy(points), torch.from_numpy(origo),
                   torch.from_numpy(mask))
    return jstate, state, jscan, scan, state.pose.numpy() + KIDNAP


def _hypotheses(center, n, seed):
    """``relocalize``'s theta-stratified draw: n poses around ``center``,
    slot 0 the center itself."""
    rng = np.random.default_rng(seed)
    g = n // 128
    thetas = center[2] + 0.3 * (-2.0 + 4.0 * (np.arange(g) + 0.5) / g)
    hyp = np.c_[center[0] + rng.normal(0, 0.6, n),
                center[1] + rng.normal(0, 0.6, n),
                np.repeat(thetas, 128)].astype(np.float32)
    hyp[0] = center
    return torch.from_numpy(hyp)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))


def test_cascade_refine_jit_equals_cascade_refine(as_on_card, bench):
    """The kidnap path's cascade (1,024 draws pruned to 256) replayed
    through the graph path: bit-equal to the eager cascade on every
    replay, the hypotheses not donated, one graph for the map."""
    _, state, _, scan, kidnapped = bench
    for seed in (3, 4):
        hyp = trec.prune_hypotheses_coarse(
            state.log_odds, _hypotheses(kidnapped, 1024, seed), scan, CFG,
            256, quads=state.quads)
        kept = hyp.clone()
        want = trec.cascade_refine(state.log_odds, hyp, scan, CFG,
                                   quads=state.quads)
        got = trec.cascade_refine_jit(state.log_odds, hyp, scan, CFG,
                                      quads=state.quads)
        assert _equal(want, got)
        assert torch.equal(kept, hyp)
        assert got[0].pose.shape == (256, 3)
    [stats] = graphs.stats()
    assert stats.name == "cascade_refine_jit" and stats.replays == 2
    assert graphs.totals()["captures"] >= 1


@pytest.mark.parametrize("level,stride,with_quad", [
    (0, 1, True), (0, 1, False), (2, 8, True), (2, 8, False), (2, 1, True),
    (0, 8, True)])
def test_residual_for_poses_jit_matches_jax(bench, level, stride, with_quad):
    jstate, state, jscan, scan, kidnapped = bench
    hyp = _hypotheses(kidnapped, 1024, 5)
    sub = ht.Scan(scan.points[::stride], scan.origo, scan.mask[::stride])
    jsub = JScan(jscan.points[::stride], jscan.origo, jscan.mask[::stride])
    got = tbatch.residual_for_poses_jit(
        state.log_odds[level], hyp, sub, CFG,
        quad=state.quads[level] if with_quad else None, level=level)
    assert torch.equal(got, tbatch.residual_for_poses(
        state.log_odds[level], hyp, sub, CFG, quad=state.quads[level],
        level=level))
    want = np.asarray(jbatch.residual_for_poses_jit(
        jstate.log_odds[level], jnp.asarray(hyp.numpy()), jsub,
        J_BENCH_CONFIG, quad=jstate.quads[level] if with_quad else None,
        level=level))
    np.testing.assert_allclose(got.numpy(), want, rtol=RESIDUAL_REL, atol=0)
    assert want.min() > 1.0


def test_recovery_bodies_make_no_host_round_trip(bench, monkeypatch):
    """The bodies the two graphs capture read nothing on the host and copy
    no host value to the device: the reads of ``no_host_reads`` raise, and
    so does an item assignment of a Python scalar (a host-to-device copy,
    which a CUDA graph cannot capture from pageable memory)."""
    _, state, _, scan, kidnapped = bench
    hyp = trec.prune_hypotheses_coarse(
        state.log_odds, _hypotheses(kidnapped, 1024, 3), scan, CFG, 256,
        quads=state.quads)
    sub = ht.Scan(scan.points[::8], scan.origo, scan.mask[::8])
    setitem = torch.Tensor.__setitem__

    def tensors_only(self, index, value):
        if not isinstance(value, torch.Tensor):
            raise AssertionError("a host round trip: an item assignment of "
                                 "a host scalar")
        return setitem(self, index, value)

    def bodies():
        yield trec.cascade_refine(state.log_odds, hyp, scan, CFG,
                                  quads=state.quads)
        yield tbatch.residual_for_poses(state.log_odds[2], hyp, sub, CFG,
                                        quad=state.quads[2], level=2)

    warm = list(bodies())
    monkeypatch.setattr(torch.Tensor, "__setitem__", tensors_only)
    with no_host_reads():
        again = list(bodies())
    assert _equal(warm[0], again[0]) and torch.equal(warm[1], again[1])
    # the control: the pruning's item assignment is refused
    with pytest.raises(AssertionError, match="host round trip"):
        hyp[0] = 0.0


def test_residual_for_poses_jit_graph_equals_eager(as_on_card, bench):
    """The sweep's route through the graph path: bit-equal to the eager
    residuals, keyed on (level, whether the quad is given)."""
    _, state, _, scan, kidnapped = bench
    sub = ht.Scan(scan.points[::8], scan.origo, scan.mask[::8])
    for seed in (6, 7):
        hyp = _hypotheses(kidnapped, 512, seed)
        for quad in (state.quads[2], None):
            assert torch.equal(
                tbatch.residual_for_poses_jit(state.log_odds[2], hyp, sub,
                                              CFG, quad=quad, level=2),
                tbatch.residual_for_poses(state.log_odds[2], hyp, sub, CFG,
                                          quad=quad, level=2))
    assert sorted(g.replays for g in graphs.stats()) == [2, 2]


def _routes(monkeypatch):
    """Records each compiled route the session calls; the eager
    ``residual_for_poses`` may score only the finest level."""
    calls = []

    def spy(name):
        fn = getattr(tsession, name)

        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    for name in ("cascade_refine_jit", "match_hypotheses_kernel_jit",
                 "match_hypotheses_mxu_jit", "match_hypotheses_jit",
                 "residual_for_poses_jit"):
        monkeypatch.setattr(tsession, name, spy(name))
    eager = tsession.residual_for_poses

    def finest_only(log_odds, poses, scan, cfg, quad=None, level=0):
        if level != 0:
            raise AssertionError("the sweep must take residual_for_poses_jit")
        return eager(log_odds, poses, scan, cfg, quad, level)

    monkeypatch.setattr(tsession, "residual_for_poses", finest_only)
    return calls


@pytest.mark.parametrize("method,n,route", [
    ("pallas", 1024, "cascade_refine_jit"),
    ("pallas", 256, "match_hypotheses_kernel_jit"),
    ("mxu", 256, "match_hypotheses_mxu_jit"),
    ("mxu", 1024, "match_hypotheses_mxu_jit"),
    ("quad", 256, "match_hypotheses_jit")])
def test_session_relocalize_takes_the_compiled_routes(as_on_card, bench,
                                                      monkeypatch, method, n,
                                                      route):
    """Each method through its compiled route (JAX session.py:431-457),
    on the graph path: one graph of that name, replayed by a second call
    from the same state with no new capture, the result unchanged.
    "mxu" (n = 256, and 1024 pruned to 256) refines JAX's batch and
    reports JAX's telemetry exactly (tests/fixtures/mxu_jax_reference.npz,
    written by tools/make_torch_mxu_reference.py: 13 of 14 GN steps past
    the repair budget, fraction 1/14), its winner within 1e-4 m and 1e-4
    rad of JAX's."""
    for name in ("cascade_refine", "match_hypotheses_kernel",
                 "match_hypotheses_mxu", "match_hypotheses"):
        assert not hasattr(tsession, name), name
    refined = []
    refine = ht.SlamSession._refine_and_accept

    def spy(self, hyp, *args, **kwargs):
        refined.append(hyp.numpy().copy())
        return refine(self, hyp, *args, **kwargs)

    monkeypatch.setattr(ht.SlamSession, "_refine_and_accept", spy)
    calls = _routes(monkeypatch)
    _, state, _, scan, kidnapped = bench
    sess = ht.SlamSession(CFG, device="cpu")
    kidnapped_state = state._replace(pose=torch.from_numpy(kidnapped))
    outs = []
    for _ in range(2):
        sess.state = kidnapped_state
        outs.append(sess.relocalize(scan=scan, n_hypotheses=n, sigma_xy=0.6,
                                    sigma_theta=0.3, seed=3, method=method))
    assert calls == [route, route]
    assert [g.name for g in graphs.stats()] == [route]
    assert graphs.stats()[0].replays == 2
    np.testing.assert_array_equal(outs[0]["pose"], outs[1]["pose"])
    assert outs[0]["residual"] == outs[1]["residual"]
    assert outs[0]["accepted"]
    if method == "mxu":
        with np.load(MXU_REFERENCE) as z:
            ref = {k[:-len(f"_{n}")]: z[k] for k in z.files
                   if k.endswith(f"_{n}")}
        np.testing.assert_array_equal(refined[0], ref["refine_hyp"])
        for out in outs:
            assert out["overflow_steps"] == int(ref["overflow_steps"])
            assert out["fast_path_fraction"] == float(
                ref["fast_path_fraction"])
            assert out["accepted"] == bool(ref["accepted"])
            assert np.linalg.norm(out["pose"][:2] - ref["pose"][:2]) < 1e-4
            assert _yaw_err(out["pose"][2], ref["pose"][2]) < 1e-4


def test_session_relocalize_global_takes_the_compiled_routes(as_on_card,
                                                             bench,
                                                             monkeypatch):
    calls = _routes(monkeypatch)
    _, state, _, scan, kidnapped = bench
    sess = ht.SlamSession(CFG, device="cpu")
    sess.state = state._replace(pose=torch.from_numpy(kidnapped))
    out = sess.relocalize_global(scan=scan, n_positions=256, n_theta=8,
                                 top_k=256, seed=1, method="pallas")
    assert calls == ["residual_for_poses_jit", "cascade_refine_jit"]
    assert sorted(g.name for g in graphs.stats()) == [
        "cascade_refine_jit", "residual_for_poses_jit"]
    assert out["n_free_cells"] > 100 and np.isfinite(out["residual"])


def test_cascade_refine_jit_matches_jax_pallas(corridor):  # noqa: F811
    """The kidnap cascade (n = 1,024 pruned to 256) through the port's
    ``cascade_refine_jit`` and JAX's ``cascade_refine_jit`` (Pallas in
    interpret mode) on the same survivors: each package's winner by its
    own finest-level residual, within 5 mm, 0.005 rad and 1%."""
    jsess, sess, scan, good = _kidnapped_pair(corridor)
    jst, st = jsess.state, sess.state
    hyp = trec.prune_hypotheses_coarse(
        st.log_odds, _hypotheses(sess.pose, 1024, 3), scan, sess.cfg, 256,
        quads=st.quads)
    jscan = jsess._last_scan
    jhyp = jrec.prune_hypotheses_coarse(
        jst.log_odds, jnp.asarray(_hypotheses(sess.pose, 1024, 3).numpy()),
        jscan, jsess.cfg, 256, quads=jst.quads)
    np.testing.assert_array_equal(hyp.numpy(), np.asarray(jhyp))
    got, diag = trec.cascade_refine_jit(st.log_odds, hyp, scan, sess.cfg,
                                        quads=st.quads)
    want, _ = jrec.cascade_refine_jit(jst.log_odds, jhyp, jscan, jsess.cfg,
                                      quads=jst.quads, interpret=True)
    res = tbatch.residual_for_poses(st.log_odds[0], got.pose, scan, sess.cfg,
                                    quad=st.quads[0]).numpy()
    jres = np.asarray(jbatch.residual_for_poses(
        jst.log_odds[0], want.pose, jscan, jsess.cfg, quad=jst.quads[0]))
    i, j = int(np.argmin(res)), int(np.argmin(jres))
    pose, jpose = got.pose[i].numpy(), np.asarray(want.pose[j])
    assert np.linalg.norm(pose[:2] - jpose[:2]) <= 5e-3
    assert _yaw_err(pose[2], jpose[2]) <= 5e-3
    assert abs(res[i] - jres[j]) <= 1e-2 * abs(jres[j])
    assert np.linalg.norm(pose[:2] - good[:2]) < 0.1
    assert float(diag.fast_path_fraction()) == 1.0
