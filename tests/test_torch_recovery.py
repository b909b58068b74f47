"""The port's recovery path against the JAX package's, on the CPU: the
top-k selection rule (ties and NaN), the pruning default, and
``SlamSession.relocalize`` / ``relocalize_global`` run from one state —
the JAX session's, carried across with ``state_from_numpy`` — so that
both packages draw the same hypotheses from the same seed.

Tolerances:
  - selections, hypotheses, pruned sets, ``accepted`` and
    ``n_free_cells``: equal;
  - method "quad" (the same torch-op and XLA matchers): winner within
    1e-4 m and 1e-4 rad, residual within 1e-4 relative; the global
    sweep's best residual within 1e-5 relative, its winner within 1e-3 m;
  - the port's "pallas" (the moments kernel's plain version on the CPU)
    against JAX's Pallas path in interpret mode (windows, repairs and a
    fallback the card's kernel does not have): winners within 5 mm and
    0.005 rad, residuals within 1%;
  - method "mxu" (the patch matcher in both packages): refine batches
    and overflowed steps equal, the fast-path fraction equal to JAX's
    (see ``test_relocalize_kernel_methods`` for the one query at
    n = 1024), winners within "quad"'s bars."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hector_slam_tpu.config import MapConfig as JMapConfig
from hector_slam_tpu.config import SlamConfig as JSlamConfig
from hector_slam_tpu.config import UpdateConfig as JUpdateConfig
from hector_slam_tpu.core.slam import init_state as j_init, run_log_jit
from hector_slam_tpu.io.scanlog import LaserModel as JLaserModel
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.io.scanlog import stack_scans as j_stack
from hector_slam_tpu.io.simulator import (World, corridor_trajectory,
                                          loop_trajectory,
                                          simulate_trajectory)
from hector_slam_tpu.parallel import recovery as jrec
from hector_slam_tpu.session import SlamSession as JSlamSession

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch import session as tsession
from hector_slam_tpu_torch.parallel import recovery as trec

KIDNAP = np.asarray([0.6, -0.5, 0.25], np.float32)
MAP_KW = dict(resolution=0.05, size_x=256, size_y=256, levels=2)
CFG_KW = dict(max_beams=192, max_ray_cells=256)
LASER_KW = dict(num_beams=181, angle_min=-1.57, angle_increment=np.pi / 180,
                range_min=0.1, range_max=8.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- selection rule ------------------------------------------------------


def _scores_with_ties_and_nan(n, group):
    """Scores whose cut falls inside a run of equal values (hypotheses
    wholly in unknown space score alike), plus a NaN (a singular H that
    passed the guard)."""
    rng = np.random.default_rng(11)
    s = rng.integers(0, 6, n).astype(np.float32)   # many exact ties
    s[3] = np.nan
    s[min(group + 5, n - 2)] = np.nan              # a NaN inside group 1
    s[-1] = -np.inf
    return s


@pytest.mark.parametrize("n,top_k", [(512, 256), (1024, 128), (384, 100),
                                     (300, 37), (16, 15)])
def test_select_top_matches_lax_top_k(n, top_k):
    """Group-aligned (whole groups of 128 by their best member) and
    element-wise selection: the survivors equal JAX's, ties broken by
    lower index and NaN ranked after every number, as lax.top_k does."""
    s = _scores_with_ties_and_nan(n, 128)
    hyp = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want = np.asarray(jrec._select_top(jnp.asarray(hyp), jnp.asarray(s),
                                       top_k))
    got = trec._select_top(torch.from_numpy(hyp), torch.from_numpy(s),
                           top_k).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 0.0   # the incumbent (slot 0) survives


def test_select_top_tie_and_nan_rule():
    """The rule itself: among equal scores the lower index wins, NaN
    comes after +inf, and slot 0 always survives."""
    s = np.asarray([5.0, 2.0, np.nan, 2.0, np.inf, 2.0, 1.0], np.float32)
    hyp = np.arange(7, dtype=np.float32)[:, None].repeat(3, 1)
    pick = trec._select_top(torch.from_numpy(hyp), torch.from_numpy(s), 4)
    np.testing.assert_array_equal(pick[:, 0].numpy(), [0, 1, 3, 6])
    pick = trec._select_top(torch.from_numpy(hyp), torch.from_numpy(s), 6)
    np.testing.assert_array_equal(pick[:, 0].numpy(), [0, 1, 3, 4, 5, 6])
    np.testing.assert_array_equal(
        trec._smallest(torch.from_numpy(s), 7).numpy(), [6, 1, 3, 5, 0, 4, 2])


def test_argmin_first_matches_jnp_argmin():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 3, (6, 40)).astype(np.float32)
    x[1, 7] = x[1, 30] = np.nan
    x[4, 0] = np.nan
    np.testing.assert_array_equal(
        trec._argmin_first(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(x), axis=1)))


def test_auto_prune_top_k_matches_jax():
    for n in (1, 128, 256, 511, 512, 513, 1000, 1024, 2048, 4096, 10000):
        assert trec.auto_prune_top_k(n) == jrec.auto_prune_top_k(n)
    assert [ht.auto_prune_top_k(n) for n in (256, 512, 1024, 4096)] == \
        [0, 128, 256, 1024]


# ---- relocalize from one state ---------------------------------------------


@pytest.fixture(scope="module")
def corridor():
    """tests/test_session.py's kidnap scenario (:348-367): a JAX session
    tracked along a 10 m corridor; returns (JAX state before the kidnap,
    its pose, ranges)."""
    sess = JSlamSession(JSlamConfig(map=JMapConfig(**MAP_KW), **CFG_KW),
                        JLaserModel(**LASER_KW))
    poses_true = corridor_trajectory(20, advance=0.05, weave=0.02)
    ranges = simulate_trajectory(World.corridor(length=10.0, width=3.0),
                                 poses_true, JLaserModel(**LASER_KW),
                                 range_noise_std=0.003)
    for r in ranges:
        sess.process_ranges(r)
    return sess.state, sess.pose.copy(), ranges


def _kidnapped_pair(corridor, shift=KIDNAP):
    """(JAX session, port session on the CPU, port scan, good pose), both
    sessions holding the same kidnapped state."""
    state, good, ranges = corridor
    jsess = JSlamSession(JSlamConfig(map=JMapConfig(**MAP_KW), **CFG_KW),
                         JLaserModel(**LASER_KW))
    jsess.state = state._replace(pose=jnp.asarray(good + shift))
    jsess._last_scan = j_scan(ranges[-1], 20.0, JLaserModel(**LASER_KW),
                              CFG_KW["max_beams"])
    cfg = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), **CFG_KW)
    sess = ht.SlamSession(cfg, ht.LaserModel(**LASER_KW), device="cpu")
    sess.state = _carry(jsess.state, cfg)
    scan = ht.scan_from_ranges(ranges[-1], cfg.map.level_scale(0),
                               ht.LaserModel(**LASER_KW), cfg.max_beams,
                               device="cpu")
    return jsess, sess, scan, good


def _carry(jstate, cfg):
    return ht.state_from_numpy(
        [np.asarray(lo) for lo in jstate.log_odds], np.asarray(jstate.pose),
        np.asarray(jstate.last_map_update_pose),
        np.asarray(jstate.covariance), int(jstate.step),
        int(jstate.map_update_count), cfg, device="cpu")


def _capture(monkeypatch):
    """Records the hypotheses each package draws (the pruner's input) and
    refines (the refine stage's input)."""
    seen = {"jax": {}, "port": {}}

    def spy(pkg, key, fn, pos):
        def wrapped(*a, **kw):
            seen[pkg][key] = np.asarray(a[pos]).copy() if pkg == "jax" \
                else a[pos].numpy().copy()
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jrec, "prune_hypotheses_coarse",
                        spy("jax", "drawn", jrec.prune_hypotheses_coarse, 1))
    monkeypatch.setattr(tsession, "prune_hypotheses_coarse",
                        spy("port", "drawn", trec.prune_hypotheses_coarse, 1))
    monkeypatch.setattr(JSlamSession, "_refine_and_accept", spy(
        "jax", "refined", JSlamSession._refine_and_accept, 1))
    monkeypatch.setattr(ht.SlamSession, "_refine_and_accept", spy(
        "port", "refined", ht.SlamSession._refine_and_accept, 1))
    return seen


def _yaw_err(a, b):
    d = float(a) - float(b)
    return abs(float(np.arctan2(np.sin(d), np.cos(d))))


def _close(got, want, m, rad, rel):
    assert got["accepted"] == want["accepted"]
    assert np.linalg.norm(got["pose"][:2] - want["pose"][:2]) <= m, (got,
                                                                     want)
    assert _yaw_err(got["pose"][2], want["pose"][2]) <= rad, (got, want)
    assert abs(got["residual"] - want["residual"]) <= rel * abs(
        want["residual"]), (got, want)


def _recovered(out, good):
    assert out["accepted"], out
    assert np.linalg.norm(out["pose"][:2] - good[:2]) < 0.1, out
    assert _yaw_err(out["pose"][2], good[2]) < 0.05, out


@pytest.mark.parametrize("n", [256, 512])
def test_relocalize_quad_matches_jax(corridor, monkeypatch, n):
    """n = 256 (no pruning) and 512 (pruned to 128): the same hypotheses
    and survivors, the same acceptance, the same winner."""
    seen = _capture(monkeypatch)
    jsess, sess, scan, good = _kidnapped_pair(corridor)
    kw = dict(n_hypotheses=n, sigma_xy=0.6, sigma_theta=0.3, seed=3,
              method="quad")
    want = jsess.relocalize(**kw)
    got = sess.relocalize(scan=scan, **kw)
    assert seen["jax"].keys() == seen["port"].keys()
    assert ("drawn" in seen["port"]) == (n >= 512)
    for key in seen["jax"]:
        np.testing.assert_array_equal(seen["port"][key], seen["jax"][key])
    assert len(seen["port"]["refined"]) == (128 if n == 512 else n)
    _close(got, want, 1e-4, 1e-4, 1e-4)
    _recovered(got, good)
    assert got["fast_path_fraction"] is None
    assert want["improvement"] > 0 and got["improvement"] > 0


def test_relocalize_recovers_and_keeps_tracking(corridor):
    """tests/test_session.py::test_relocalize_recovers_kidnapped_robot on
    the port: the legacy use_pallas=False spelling, then the next scan
    tracks from the recovered pose; a session with no scan raises."""
    _, sess, scan, good = _kidnapped_pair(corridor)
    _, _, ranges = corridor
    out = sess.relocalize(scan=scan, n_hypotheses=256, sigma_xy=0.6,
                          sigma_theta=0.3, seed=3, use_pallas=False)
    _recovered(out, good)
    np.testing.assert_array_equal(sess.pose, out["pose"])
    p_next = sess.process_ranges(ranges[-1])
    assert np.linalg.norm(p_next[:2] - good[:2]) < 0.1
    fresh = ht.SlamSession(sess.cfg, sess.laser, device="cpu")
    with pytest.raises(ValueError):
        fresh.relocalize()


@pytest.mark.parametrize("method", ["pallas", "mxu"])
def test_relocalize_kernel_methods(corridor, monkeypatch, method):
    """tests/test_session.py::test_relocalize_production_methods: "pallas"
    (the moments kernel, its plain version on the CPU) recovers and
    reports the whole batch on the kernel; "mxu" goes through
    ``match_hypotheses_mxu_jit`` with JAX's bucket count, refines the
    same batch as JAX, recovers within "quad"'s bars of JAX's winner,
    and reports JAX's telemetry:
      - n = 256 (no pruning): the JAX session's 0.10000002 and 9
        overflowed steps, exactly;
      - n = 1024 (pruned to 256): the JAX session's 8 overflowed steps,
        and the fast-path fraction of JAX's op-by-op
        ``match_hypotheses_mxu`` on the same batch exactly (0.19977212,
        112 repaired queries). The JAX session's compiled matcher reads
        0.19977009: one query more left out of its patch at level 1's
        second GN step. That step follows hypothesis 255 of the batch
        (at the map's edge), whose first level-1 Hessian has a condition
        number of 1.8e9: the f32 order of the Hessian's sum, which
        differs between XLA's compiled and op-by-op runs, moves its
        iterate by up to 16 cells. The port sums as the op-by-op run
        does here. Not a sin/cos ulp: from equal iterates the two
        packages leave out the same queries at every step."""
    if method == "pallas":
        _, sess, scan, good = _kidnapped_pair(corridor)
        out = sess.relocalize(scan=scan, n_hypotheses=256, sigma_xy=0.6,
                              sigma_theta=0.3, seed=3, method=method)
        _recovered(out, good)
        assert out["fast_path_fraction"] == 1.0
        assert out["overflow_steps"] == 0
        return
    from hector_slam_tpu.parallel import onehot_match as jom
    seen = _capture(monkeypatch)
    buckets = []
    mxu = tsession.match_hypotheses_mxu_jit

    def spy(*a, **kw):
        buckets.append(kw["num_buckets"])
        return mxu(*a, **kw)

    monkeypatch.setattr(tsession, "match_hypotheses_mxu_jit", spy)
    for n, frac, steps in ((256, 0.10000002384185791, 9),
                           (1024, 0.19977009296417236, 8)):
        jsess, sess, scan, good = _kidnapped_pair(corridor)
        kw = dict(n_hypotheses=n, sigma_xy=0.6, sigma_theta=0.3, seed=3,
                  method="mxu")
        want = jsess.relocalize(**kw)
        got = sess.relocalize(scan=scan, **kw)
        np.testing.assert_array_equal(seen["port"]["refined"],
                                      seen["jax"]["refined"])
        assert (want["fast_path_fraction"], want["overflow_steps"]) == (
            frac, steps)
        assert got["overflow_steps"] == want["overflow_steps"], (got, want)
        if n == 256:
            assert got["fast_path_fraction"] == want["fast_path_fraction"]
        else:
            hyp = seen["jax"]["refined"]
            _, diag = jom.match_hypotheses_mxu(
                jsess.state.log_odds, jnp.asarray(hyp), jsess._last_scan,
                jsess.cfg, num_buckets=jom.auto_num_buckets(hyp),
                with_diag=True)
            assert got["fast_path_fraction"] == float(
                diag.fast_path_fraction()) == 0.19977211952209473
            assert int(diag.repaired_queries) == 112
            # the one query: 1 / (256 hypotheses x 192 beams x 10 steps)
            assert round((got["fast_path_fraction"] - frac) * 491520) == 1
        _close(got, want, 1e-4, 1e-4, 1e-4)
        _recovered(got, good)
    assert buckets == [2, 2]


def test_relocalize_cascade_matches_jax_pallas(corridor):
    """n = 1024 prunes to 256 and runs the cascade (coarse refine, group
    re-selection with the trust region, fine refine): the port's
    "pallas" against JAX's Pallas path in interpret mode."""
    jsess, sess, scan, good = _kidnapped_pair(corridor)
    kw = dict(n_hypotheses=1024, sigma_xy=0.6, sigma_theta=0.3, seed=3,
              method="pallas")
    want = jsess.relocalize(pallas_interpret=True, **kw)
    got = sess.relocalize(scan=scan, **kw)
    _close(got, want, 5e-3, 5e-3, 1e-2)
    _recovered(got, good)
    assert got["fast_path_fraction"] == 1.0


def test_relocalize_strict_accept_keeps_pose(corridor):
    """tests/test_session.py::test_relocalize_strict_accept_keeps_pose:
    with the incumbent alone nothing beats it, and nothing changes."""
    jsess, sess, scan, _ = _kidnapped_pair(corridor, shift=np.zeros(3))
    pose, cov = sess.pose.copy(), sess.covariance.copy()
    out = sess.relocalize(scan=scan, n_hypotheses=1, method="quad")
    want = jsess.relocalize(n_hypotheses=1, method="quad")
    assert not out["accepted"] and not want["accepted"]
    assert out["improvement"] == 0.0
    np.testing.assert_array_equal(sess.pose, pose)
    np.testing.assert_array_equal(sess.covariance, cov)
    with pytest.raises(ValueError):
        sess.relocalize(scan=scan, method="bogus")


def test_relocalize_pruning_keeps_recovery_quality(corridor):
    """tests/test_session.py::test_relocalize_coarse_pruning_recovers:
    auto-pruning at n = 512 recovers as well as no pruning."""
    _, sess, scan, good = _kidnapped_pair(corridor)
    kw = dict(scan=scan, n_hypotheses=512, sigma_xy=0.6, sigma_theta=0.3,
              seed=3, method="quad")
    out = sess.relocalize(**kw)
    _recovered(out, good)
    _, sess2, _, _ = _kidnapped_pair(corridor)
    out2 = sess2.relocalize(prune_top_k=0, **kw)
    assert out2["accepted"]
    assert abs(out["residual"] - out2["residual"]) < 0.1 * max(
        out2["residual"], 1.0)


def test_relocalize_auto_method_on_the_cpu(corridor):
    """tests/test_session.py::test_relocalize_auto_method: with no method
    a CPU session takes "quad" (no fast path to report)."""
    _, sess, scan, _ = _kidnapped_pair(corridor)
    out = sess.relocalize(scan=scan, n_hypotheses=128, seed=1)
    assert out["fast_path_fraction"] is None


# ---- relocalize_global from one state --------------------------------------


@pytest.mark.parametrize("model", ["simple_count", "log_odds"])
def test_relocalize_global_matches_jax(model):
    """tests/test_session.py::test_relocalize_global_simple_count_cell_model
    (free cells classified by the session's own cell model), both
    models, from the JAX session's state."""
    jcfg = JSlamConfig(map=JMapConfig(**MAP_KW), **CFG_KW,
                       update=JUpdateConfig(cell_model=model))
    cfg = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), **CFG_KW,
                        update=ht.UpdateConfig(cell_model=model))
    jsess = JSlamSession(jcfg, JLaserModel(**LASER_KW))
    poses_true = corridor_trajectory(15, advance=0.05, weave=0.02)
    ranges = simulate_trajectory(World.corridor(length=10.0, width=3.0),
                                 poses_true, JLaserModel(**LASER_KW),
                                 range_noise_std=0.003)
    for r in ranges:
        jsess.process_ranges(r)
    sess = ht.SlamSession(cfg, ht.LaserModel(**LASER_KW), device="cpu")
    sess.state = _carry(jsess.state, cfg)
    scan = ht.scan_from_ranges(ranges[-1], cfg.map.level_scale(0),
                               ht.LaserModel(**LASER_KW), cfg.max_beams,
                               device="cpu")
    kw = dict(n_positions=256, n_theta=8, top_k=128, method="quad", seed=1)
    want = jsess.relocalize_global(**kw)
    got = sess.relocalize_global(scan=scan, **kw)
    assert got["n_free_cells"] == want["n_free_cells"] > 50
    assert abs(got["sweep_best_residual"] - want["sweep_best_residual"]) \
        <= 1e-5 * want["sweep_best_residual"]
    assert got["accepted"] == want["accepted"]
    assert np.linalg.norm(got["pose"][:2] - want["pose"][:2]) <= 1e-3
    assert np.isfinite(got["residual"])


def test_global_relocalization_unknown_position_matches_jax():
    """tests/test_adverse_logs.py::test_global_relocalization_unknown_position:
    the multi-room loop mapped by JAX, the believed pose teleported to
    another room with a wrong heading; both packages recover to < 0.1 m
    from the same state, with equal free-cell counts."""
    jcfg = JSlamConfig(map=JMapConfig(resolution=0.05, size_x=512,
                                      size_y=512, levels=3),
                       max_beams=576, max_ray_cells=384)
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=512,
                                         size_y=512, levels=3),
                        max_beams=576, max_ray_cells=384)
    kw = dict(num_beams=541, angle_min=-2.356194490192345,
              angle_increment=2 * 0.004363323129985824, range_min=0.1,
              range_max=20.0)
    jlaser = JLaserModel(**kw)
    ranges = simulate_trajectory(World.multi_room(),
                                 loop_trajectory(num_steps=280, weave=0.02),
                                 jlaser, range_noise_std=0.01, seed=7)
    jstate, poses, _ = run_log_jit(j_init(jcfg), j_stack(
        [j_scan(r, 20.0, jlaser, jcfg.max_beams) for r in ranges]), jcfg)
    tracked = np.asarray(poses[-1])
    jstate = jstate._replace(pose=jnp.asarray(
        tracked + np.asarray([-5.0, -4.0, 2.0], np.float32)))
    jsess = JSlamSession(jcfg, jlaser)
    jsess.state = jstate
    sess = ht.SlamSession(cfg, ht.LaserModel(**kw), device="cpu")
    sess.state = _carry(jstate, cfg)
    gkw = dict(n_positions=4096, n_theta=32, top_k=255, seed=4,
               method="quad")
    want = jsess.relocalize_global(
        scan=j_scan(ranges[-1], 20.0, jlaser, jcfg.max_beams), **gkw)
    got = sess.relocalize_global(scan=ht.scan_from_ranges(
        ranges[-1], 20.0, ht.LaserModel(**kw), cfg.max_beams, device="cpu"),
        **gkw)
    for out in (got, want):
        _recovered(out, tracked)
        assert out["n_free_cells"] > 100
    assert got["n_free_cells"] == want["n_free_cells"]
    assert abs(got["sweep_best_residual"] - want["sweep_best_residual"]) \
        <= 1e-5 * want["sweep_best_residual"]
    assert np.linalg.norm(got["pose"][:2] - want["pose"][:2]) <= 1e-3
