"""The port's theta-bucketed patch matcher (parallel/onehot_match.py) and
the granular repair (ops/interp_moments.py) against the JAX package's
(mirrors tests/test_parallel.py:147-247), on the same seeded inputs.

Tolerances:
  - the cell choice (sort order, cells, patch bases, ``fits_q``) and the
    fractions: equal. The inputs are drawn where torch's and XLA's sin
    and cos agree, since a 1-ulp difference there (ROADMAP, expected
    differences) is the one place the two packages' cell choices may
    part; with equal sines both compute the same f32 coordinates;
  - a GN step on the wide spread: ``n_bad`` and ``overflowed`` equal;
    poses within rtol = atol = 1e-6 and Hessians within 1e-4 x max|H| of
    JAX's per-pose ``gn_step``, as JAX's own test holds its batch;
  - the matcher on a 512^2 x 3 map at B = 512: the diag equal, poses
    within 2e-5 and Hessians within 2e-5 x max|H| of JAX's
    ``match_hypotheses_mxu_jit`` (the Hessians' f32 sums run in another
    order);
  - the repair: compaction indices and validity equal, corrections
    within 1e-5 x max|correction| of JAX's ``segment_sum``;
  - ``onehot_bf16``, a float32 matmul precision of "high", the graph
    path and its replays: bit-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import hector_slam_tpu.parallel.onehot_match as jom
from hector_slam_tpu.config import MapConfig as JMapConfig
from hector_slam_tpu.config import SlamConfig as JSlamConfig
from hector_slam_tpu.core.cell_models import prob_grid as j_prob_grid
from hector_slam_tpu.core.grid import world_to_map_pose as j_w2m
from hector_slam_tpu.core.interp import quad_pack as j_quad_pack
from hector_slam_tpu.core.matcher import gn_step as j_gn_step
from hector_slam_tpu.core.slam import init_state as j_init, slam_step_jit
from hector_slam_tpu.io.scanlog import LaserModel as JLaserModel
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.io.simulator import (World, corridor_trajectory,
                                          simulate_trajectory)
from hector_slam_tpu.ops import pallas_interp as jpi

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import graphs
from hector_slam_tpu_torch.core.cell_models import prob_grid
from hector_slam_tpu_torch.core.grid import world_to_map_pose
from hector_slam_tpu_torch.core.interp import quad_pack
from hector_slam_tpu_torch.ops import interp_moments as tim
from hector_slam_tpu_torch.parallel import onehot_match as tom
from test_torch_graphs import no_host_reads
from test_torch_graphs_replay import as_on_card  # noqa: F401
from test_torch_queries_compiled import no_syncing_ops

CELL_FIELDS = ("order", "pm", "tx", "ty", "in_bounds", "fx", "fy", "cx",
               "ry", "x0", "y0", "fits_q")
MAP_KW = dict(resolution=0.05, size_x=512, size_y=512, levels=3)
LASER_KW = dict(num_beams=181, angle_min=-1.57, angle_increment=0.01745,
                range_min=0.1, range_max=12.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same_trig(theta):
    """Where torch's and XLA's f32 sin and cos of ``theta`` agree."""
    t = torch.from_numpy(theta)
    j = jnp.asarray(theta)
    return ((torch.sin(t).numpy() == np.asarray(jnp.sin(j)))
            & (torch.cos(t).numpy() == np.asarray(jnp.cos(j))))


def _draw_poses(rng, b, draw):
    """``b`` poses from ``draw(rng, k)`` whose sines and cosines agree in
    both packages."""
    out = np.zeros((0, 3), np.float32)
    while len(out) < b:
        p = draw(rng, 4 * b).astype(np.float32)
        out = np.concatenate([out, p[_same_trig(p[:, 2])]])
    return out[:b]


# ---- the wide spread (tests/test_parallel.py:214-247) -----------------------


@pytest.fixture(scope="module")
def wide():
    """A random 256^2 map, 64 beams over +-60 cells, 32 hypotheses spread
    over the whole map and over +-3 rad: far wider than the patches."""
    rng = np.random.default_rng(3)
    lo = rng.normal(0, 1.0, (256, 256)).astype(np.float32)
    pts = rng.uniform(-60, 60, (64, 2)).astype(np.float32)
    mask = np.ones(64, bool)
    mask[[5, 40]] = False
    poses = _draw_poses(rng, 32, lambda r, k: np.c_[
        r.uniform(40, 210, (k, 2)), r.uniform(-3, 3, k)])
    return lo, pts, mask, poses


def _cells(shape, poses, pts, mask, g):
    got = tom._cells_and_extents(shape, torch.from_numpy(poses),
                                 torch.from_numpy(pts),
                                 torch.from_numpy(mask), g)
    want = jom._cells_and_extents(shape, jnp.asarray(poses),
                                  jnp.asarray(pts), jnp.asarray(mask), g)
    return got, want


def test_cells_and_extents_equal_jax_on_the_wide_spread(wide):
    lo, pts, mask, poses = wide
    for g in (1, 2, 4):
        got, want = _cells((256, 256), poses, pts, mask, g)
        for name, a, b in zip(CELL_FIELDS, got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        assert not bool(got[-1].all())


@pytest.mark.parametrize("k_budget", [4096, 2])
def test_gn_step_batch_matches_jax_on_the_wide_spread(wide, k_budget):
    """Within the budget the left-out queries are repaired one by one;
    with a budget of 2 the step takes the full path. ``n_bad`` and
    ``overflowed`` equal JAX's; each hypothesis's step matches JAX's
    per-pose ``gn_step``."""
    lo, pts, mask, poses = wide
    jgrid = j_prob_grid(jnp.asarray(lo), "log_odds")
    jquad = j_quad_pack(jgrid)
    grid = prob_grid(torch.from_numpy(lo), "log_odds")
    got_est, got_h, (n_bad, ovf) = tom.gn_step_batch(
        grid, quad_pack(grid), (256, 256), torch.from_numpy(poses),
        torch.from_numpy(pts), torch.from_numpy(mask), 2, k_budget=k_budget)
    _, _, (j_bad, j_ovf) = jom.gn_step_batch(
        jgrid, jquad, (256, 256), jnp.asarray(poses), jnp.asarray(pts),
        jnp.asarray(mask), 2, k_budget=k_budget)
    assert int(n_bad) == int(j_bad) > 2
    assert bool(ovf) == bool(j_ovf) == (k_budget == 2)
    for i in range(len(poses)):
        want_est, want_h = j_gn_step(jquad, (256, 256), jnp.asarray(poses[i]),
                                     jnp.asarray(pts), jnp.asarray(mask))
        np.testing.assert_allclose(got_est[i].numpy(), np.asarray(want_est),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            got_h[i].numpy(), np.asarray(want_h),
            atol=1e-4 * max(1.0, float(np.abs(np.asarray(want_h)).max())))


# ---- the granular repair ------------------------------------------------------


@pytest.mark.parametrize("length,k,density", [
    (5000, 64, 0.05), (4096, 300, 0.05), (1000, 16, 0.0), (777, 900, 0.5),
    (64 * 200, 4096, 0.9)])
def test_first_k_indices_equal_jax(length, k, density):
    """The two-level compaction: the first k set bits' indices, validity
    and total, including a short pad, no bit set, and k past the total
    (the invalid ranks' indices too)."""
    rng = np.random.default_rng(length + k)
    flat = rng.random(length) < density
    idx, valid, total = tim._first_k_indices(torch.from_numpy(flat), k)
    j_idx, j_valid, j_total = jpi._first_k_indices(jnp.asarray(flat), k)
    assert int(total) == int(j_total) == int(flat.sum())
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert idx.dtype == torch.int32
    want = np.flatnonzero(flat)[:k]
    np.testing.assert_array_equal(idx.numpy()[:len(want)], want)


@pytest.mark.parametrize("k_budget", [4096, 37])
def test_bad_query_corrections_match_jax(wide, k_budget):
    """The wide spread's left-out queries repaired: every hypothesis's
    H and dTr correction against JAX's ``segment_sum``, with the whole
    budget and with one that covers only the first 37."""
    lo, pts, mask, poses = wide
    grid = prob_grid(torch.from_numpy(lo), "log_odds")
    quad = quad_pack(grid)
    jquad = j_quad_pack(j_prob_grid(jnp.asarray(lo), "log_odds"))
    got, want = _cells((256, 256), poses, pts, mask, 2)
    bad = got[4] & torch.from_numpy(mask)[None, :] & ~got[-1]
    pm = got[1]
    h, d = tim.bad_query_corrections(
        quad, (256, 256), got[2], got[3], torch.sin(pm[:, 2]),
        torch.cos(pm[:, 2]), torch.from_numpy(pts), bad, k_budget)
    jpm = want[1]
    jh, jd = jpi.bad_query_corrections(
        jquad, (256, 256), want[2], want[3], jnp.sin(jpm[:, 2]),
        jnp.cos(jpm[:, 2]), jnp.asarray(pts), jnp.asarray(bad.numpy()),
        k_budget)
    assert int(bad.sum()) > 37
    for a, b in ((h, jh), (d, jd)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-5 * float(np.abs(b).max()))
    if k_budget == 37:
        covered = torch.zeros(len(poses), dtype=torch.bool)
        covered[torch.nonzero(bad.reshape(-1))[:37, 0] // len(pts)] = True
        assert bool((h.reshape(len(poses), -1).abs().sum(-1) > 0)
                    .eq(covered).all())


def test_run_sums_is_a_per_run_sum():
    """The repair's fixed-order sum: each run of equal ids summed (within
    f32 rounding of the f64 sum), +0 for ids with no term, the invalid
    suffix (id = the segment count) dropped."""
    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 50, 700))
    seg[-40:] = 60
    terms = rng.normal(0, 1, (700, 9)).astype(np.float32)
    got = tim._run_sums(torch.from_numpy(terms), torch.from_numpy(seg),
                        60).numpy()
    want = np.zeros((60, 9))
    np.add.at(want, seg[seg < 60], terms[seg < 60].astype(np.float64))
    np.testing.assert_allclose(got, want, atol=1e-5)
    empty = np.setdiff1d(np.arange(60), seg)
    assert (got[empty] == 0).all() and not np.signbit(got[empty]).any()


# ---- the matcher (tests/test_parallel.py:147-211) ----------------------------


@pytest.fixture(scope="module")
def room():
    """The corridor map of test_mxu_matcher_equivalence (512^2 x 3, eight
    known-pose scans), in both packages, its last scan, and B = 512
    hypotheses clustered around the last pose (sigma 0.05)."""
    jcfg = JSlamConfig(map=JMapConfig(**MAP_KW), max_beams=256,
                       max_ray_cells=320)
    cfg = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_beams=256,
                        max_ray_cells=320)
    laser = JLaserModel(**LASER_KW)
    poses_true = corridor_trajectory(8, advance=0.1, weave=0.03)
    ranges = simulate_trajectory(World.corridor(length=10.0, width=3.0),
                                 poses_true, laser, range_noise_std=0.005)
    scans = [j_scan(r, jcfg.map.level_scale(0), laser, jcfg.max_beams)
             for r in ranges]
    jstate = j_init(jcfg)
    for sc, p in zip(scans, poses_true):
        jstate, _ = slam_step_jit(jstate, sc, jcfg, pose_hint=jnp.asarray(p),
                                  map_without_matching=True)
    levels = [torch.from_numpy(np.array(lo)) for lo in jstate.log_odds]
    jscan = scans[-1]
    scan = ht.Scan(*(torch.from_numpy(np.array(x)) for x in jscan))
    rng = np.random.default_rng(0)
    hyps = _draw_poses(rng, 512, lambda r, k: poses_true[-1]
                       + r.normal(0, 0.05, (k, 3)))
    return jcfg, cfg, jstate.log_odds, levels, jscan, scan, hyps


def test_cells_and_extents_equal_jax_when_clustered(room):
    """Clustered hypotheses: the cell choice equals JAX's, and the fast
    path covers every valid query (JAX's test asserts the same)."""
    _, cfg, _, _, jscan, scan, hyps = room
    est = world_to_map_pose(torch.from_numpy(hyps), cfg.map.top_left_offset,
                            cfg.map.level_scale(0))
    jest = j_w2m(jnp.asarray(hyps), cfg.map.top_left_offset,
                 cfg.map.level_scale(0))
    np.testing.assert_array_equal(est.numpy(), np.asarray(jest))
    got = tom._cells_and_extents((512, 512), est, scan.points, scan.mask, 2)
    want = jom._cells_and_extents((512, 512), jest, jscan.points,
                                  jscan.mask, 2)
    for name, a, b in zip(CELL_FIELDS, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert bool((got[-1] | ~scan.mask[None, :]).all())


def _diag(d):
    return [float(x) for x in d]


def test_match_hypotheses_mxu_matches_jax(room):
    """The whole pyramid at B = 512: the telemetry equal to JAX's (no
    repair, no overflow, fraction 1), poses and Hessians within the bars;
    the compiled name's eager path equal to the function."""
    jcfg, cfg, jlevels, levels, jscan, scan, hyps = room
    got, diag = tom.match_hypotheses_mxu(levels, torch.from_numpy(hyps),
                                         scan, cfg, with_diag=True)
    want, jdiag = jom.match_hypotheses_mxu_jit(jlevels, jnp.asarray(hyps),
                                               jscan, jcfg, with_diag=True)
    assert _diag(diag) == _diag(jdiag)
    assert _diag(diag)[:2] == [0.0, 0.0]
    assert float(diag.fast_path_fraction()) == 1.0
    assert diag.repaired_queries.dtype == torch.int32
    assert diag.total_queries.dtype == torch.float32
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose),
                               atol=2e-5)
    wh = np.asarray(want.hessian)
    np.testing.assert_allclose(got.hessian.numpy(), wh,
                               atol=2e-5 * float(np.abs(wh).max()))
    jit, jit_diag = ht.match_hypotheses_mxu_jit(
        levels, torch.from_numpy(hyps), scan, cfg, with_diag=True)
    assert torch.equal(jit.pose, got.pose)
    assert torch.equal(jit.hessian, got.hessian)
    assert _diag(jit_diag) == _diag(diag)
    alone = ht.match_hypotheses_mxu(levels, torch.from_numpy(hyps), scan, cfg)
    assert isinstance(alone, ht.MatchResult)
    assert torch.equal(alone.pose, got.pose)


def test_match_hypotheses_mxu_empty_scan_returns_the_poses(room):
    """ScanMatcher.h:68,189: an empty scan returns every pose verbatim."""
    _, cfg, _, levels, _, _, hyps = room
    empty = ht.Scan(torch.zeros((256, 2)), torch.zeros(2),
                    torch.zeros(256, dtype=torch.bool))
    got = ht.match_hypotheses_mxu_jit(levels, torch.from_numpy(hyps), empty,
                                      cfg)
    np.testing.assert_array_equal(got.pose.numpy(), hyps)
    assert not got.hessian.any()


def test_match_hypotheses_mxu_bit_equal_across_options(room):
    """``onehot_bf16`` True and False, any float32 matmul precision (the
    selection is a gather, not a contraction), and an unpadded beam
    count, all bit-equal; a bucket count that does not divide B is
    lowered as JAX lowers it."""
    _, cfg, _, levels, _, scan, hyps = room
    args = (levels, torch.from_numpy(hyps[:384]), scan, cfg)
    base, diag = tom.match_hypotheses_mxu(*args, num_buckets=5,
                                          with_diag=True)
    bf16, _ = tom.match_hypotheses_mxu(*args, num_buckets=4,
                                       onehot_bf16=True, with_diag=True)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        high, _ = tom.match_hypotheses_mxu(*args, num_buckets=4,
                                           with_diag=True)
    finally:
        torch.set_float32_matmul_precision(prev)
    for other in (bf16, high):
        assert torch.equal(other.pose, base.pose)
        assert torch.equal(other.hessian, base.hessian)
    odd = ht.Scan(scan.points[:251], scan.origo, scan.mask[:251])
    padded = ht.Scan(torch.cat([odd.points, torch.zeros((5, 2))]),
                     odd.origo, torch.cat([odd.mask,
                                           torch.zeros(5, dtype=torch.bool)]))
    a, da = tom.match_hypotheses_mxu(levels, args[1], odd, cfg,
                                     with_diag=True)
    b, db = tom.match_hypotheses_mxu(levels, args[1], padded, cfg,
                                     with_diag=True)
    assert torch.equal(a.pose, b.pose) and _diag(da) == _diag(db)


def test_auto_num_buckets_equals_jax():
    rng = np.random.default_rng(1)
    for b in (1, 100, 128, 256, 384, 1000, 1024, 4096, 8192):
        for spread in (0.0, 0.05, 0.19, 0.4, 0.75, 1.2, 3.0, 6.3):
            poses = np.c_[rng.normal(0, 1, (b, 2)),
                          rng.uniform(0, spread, b)].astype(np.float32)
            assert tom.auto_num_buckets(poses) == jom.auto_num_buckets(poses)
            assert tom.auto_num_buckets(torch.from_numpy(poses)) == \
                jom.auto_num_buckets(poses)
            assert tom.auto_num_buckets(poses, 4 * b) == \
                jom.auto_num_buckets(poses, 4 * b)


def test_match_hypotheses_mxu_jit_graph_path(as_on_card, room):
    """The compiled name on the graph path: bit-equal to the eager
    function on every replay, one capture for the map and statics, and
    a body that reads nothing on the host (the repair and the full path
    run on every step and are selected on the device)."""
    _, cfg, _, levels, _, scan, hyps = room
    body = ht.match_hypotheses_mxu(levels, torch.from_numpy(hyps[:256]),
                                   scan, cfg, num_buckets=2, k_budget=8,
                                   with_diag=True)
    with no_host_reads(), no_syncing_ops():
        again = ht.match_hypotheses_mxu(levels, torch.from_numpy(hyps[:256]),
                                        scan, cfg, num_buckets=2,
                                        k_budget=8, with_diag=True)
    assert torch.equal(again[0].pose, body[0].pose)
    for seed in (1, 2):
        hyp = torch.from_numpy(hyps[:256] + np.random.default_rng(seed)
                               .normal(0, 0.2, (256, 3)).astype(np.float32))
        want = ht.match_hypotheses_mxu(levels, hyp, scan, cfg, num_buckets=2,
                                       k_budget=8, with_diag=True)
        got = ht.match_hypotheses_mxu_jit(levels, hyp, scan, cfg,
                                          num_buckets=2, k_budget=8,
                                          with_diag=True)
        assert torch.equal(got[0].pose, want[0].pose)
        assert torch.equal(got[0].hessian, want[0].hessian)
        assert _diag(got[1]) == _diag(want[1])
        assert _diag(got[1])[1] > 0   # some step overflowed the budget
    [stats] = graphs.stats()
    assert stats.name == "match_hypotheses_mxu_jit" and stats.replays == 2
