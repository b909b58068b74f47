"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same CUDA tensors. Every test here carries the
``cuda`` marker and skips (inside a fixture) without a card.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only the port; ``tests/conftest.py`` imports JAX, so
skip it there:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the moments kernel takes the wrapper's sin/cos and rounds
the transform, bounds test, int floor and fractions as the plain version
does (no implicit FMA, -fmad=false), so it picks the same cells and its
used counts are held exactly; after the cell choice it computes with
explicit FMAs and sums in its own fixed order, so its per-query terms
differ from the plain version's by ulps, and moments are held to 1e-5 of
the batch's largest |moment| (chip_smoke.py holds them to 1e-5 of each
hypothesis's). The paint kernel stores bytes: its grids are held exactly
equal to the plain version's, and a fleet on the card bit-equal to its
robots run one by one through ``slam_step``. The probe kernels (take_along,
dyn_slice, paint_runs) are held exactly equal to their plain versions;
matmul_stationary within MM_ULPS bf16 ulps per element, because the
tensor core sums a rep's products in its own order (the plain version
and the JAX probe read 0 ulps apart on the CPU, tests/test_torch_probes.py)."""

import os

import numpy as np
import pytest
import torch

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core.interp import quad_pack
from hector_slam_tpu_torch.io.simulator import (World, loop_trajectory,
                                                simulate_trajectory)
from hector_slam_tpu_torch.ops import interp_moments as im
from hector_slam_tpu_torch.ops import dyn_slice as dsl
from hector_slam_tpu_torch.ops import matmul_stationary as mms
from hector_slam_tpu_torch.ops import paint_cells as pc
from hector_slam_tpu_torch.ops import paint_runs as pr
from hector_slam_tpu_torch.ops.raster_paint import raster_paint
from hector_slam_tpu_torch.ops import take_along as ta

TOL = 1e-5
MM_ULPS = 2
# matmul_stationary's chain at the probe's operand scales: every value
# denormal, and at least 2 smallest-denormal steps above 0 (from ~200 reps
# on the plain version's chain sits at the smallest bf16 denormal, 2^-133:
# 0.64 of it rounds up to it, so a flush to 0 would read only 1 ulp there)
MM_DENORMAL_REPS = 195


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _moments_inputs(dev, b, n, n_valid, size=256, seed=35):
    """A random grid, a ring of beams (some beyond the map edge) and b
    poses around the centre with a wide spread."""
    rng = np.random.default_rng(seed)
    grid = rng.random((size, size), dtype=np.float32)
    ang = np.linspace(-2.356, 2.356, n).astype(np.float32)
    rad = rng.uniform(0.02, 0.6, n).astype(np.float32) * size
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    poses = np.c_[size / 2 + rng.normal(0, 12.0, (b, 2)),
                  rng.normal(0, 0.05, b)].astype(np.float32)
    return (quad_pack(torch.from_numpy(grid).to(dev)), (size, size),
            torch.from_numpy(poses).to(dev),
            torch.from_numpy(pts.astype(np.float32)).to(dev),
            torch.from_numpy(np.arange(n) < n_valid).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 512, 4096])
@pytest.mark.parametrize("n,n_valid", [(64, 60), (1152, 1081), (200, 0)])
def test_kernel_matches_plain_on_card(cuda_device, b, n, n_valid):
    """B not a multiple of the block's 8 hypotheses, N not a multiple of
    32 x 4, the tail masked or every beam masked."""
    args = _moments_inputs(cuda_device, b, n, n_valid)
    before = im.interp_moments.launches
    k = im.interp_moments(*args)
    assert im.interp_moments.launches == before + 1
    p = im.interp_moments_plain(*args)
    assert torch.equal(k.used, p.used)
    if n_valid == 0:
        assert not k.hess.any() and not k.dtr.any()
        return
    assert _rel(k.hess, p.hess) < TOL
    assert _rel(k.dtr, p.dtr) < TOL
    again = im.interp_moments(*args)
    assert all(torch.equal(x, y) for x, y in zip(k, again))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda_device):
    quad, shape, poses, pts, mask = _moments_inputs(cuda_device, 8, 64, 64)
    with pytest.raises(ValueError):
        im.interp_moments(quad, shape, poses.cpu(), pts, mask)
    with pytest.raises(ValueError):
        im.interp_moments(quad, shape, poses, pts.t().contiguous().t(), mask)
    with pytest.raises(TypeError):
        im.interp_moments(quad, shape, poses.double(), pts, mask)


@pytest.mark.cuda
def test_batched_match_through_kernel_on_card(cuda_device):
    """A small map built on the card with known poses; 64 hypotheses
    matched through the kernel (one launch of its level form a level) and
    through the plain batched matcher agree."""
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=256,
                                         size_y=256, levels=2),
                        max_ray_cells=256)
    laser = ht.LaserModel(num_beams=181, angle_min=-1.57,
                          angle_increment=np.pi / 180, range_max=8.0)
    poses_true = np.zeros((8, 3), np.float32)
    poses_true[:, 0] = np.linspace(0, 0.4, 8)
    ranges = simulate_trajectory(World.corridor(length=8.0, width=3.0),
                                 poses_true, laser, range_noise_std=0.0)
    scans = [ht.scan_from_ranges(r, cfg.map.level_scale(0), laser,
                                 cfg.max_beams, device=cuda_device)
             for r in ranges]
    state = ht.init_state(cfg, device=cuda_device)
    for sc, pose in zip(scans, poses_true):
        state, _ = ht.slam_step(state, sc, cfg,
                                pose_hint=torch.from_numpy(pose).to(
                                    cuda_device),
                                map_without_matching=True)
    rng = np.random.default_rng(7)
    hyp = torch.from_numpy((poses_true[-1] + np.c_[
        rng.normal(0, 0.03, (64, 2)), rng.normal(0, 0.02, 64)]).astype(
            np.float32)).to(cuda_device)
    before = im.interp_moments.launches
    level0 = im.interp_moments_level.launches
    got, diag = ht.match_hypotheses_kernel(state.log_odds, hyp, scans[-1],
                                           cfg, quads=state.quads)
    # one launch of the level form a level, every GN step inside it
    assert im.interp_moments_level.launches == level0 + cfg.map.levels
    assert im.interp_moments.launches == before
    want = ht.match_pyramid(state.log_odds, hyp, scans[-1], cfg,
                            quads=state.quads)
    diff = (got.pose - want.pose).abs().max(-1).values.cpu().numpy()
    assert np.isfinite(got.pose.cpu().numpy()).all()
    assert np.percentile(diff, 90) < 2e-3
    assert float(diag.slow_queries) == 0.0


def _bits_equal(a, b):
    """Bit for bit, NaNs included (torch.equal counts no NaN equal)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.fixture(scope="module")
def tutorial_map():
    """TUTORIAL_CONFIG's 2048^2, 2-level pyramid mapped on the card from the
    first 10 simulated UTM-30LX scans of the four-room loop at their true
    poses, the last scan, and 4,096 hypotheses about its pose (0.05 m,
    0.05 rad)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    cfg = ht.TUTORIAL_CONFIG
    laser = ht.LaserModel()
    poses = loop_trajectory(754)[:10]
    ranges = simulate_trajectory(World.multi_room(), poses, laser,
                                 range_noise_std=0.01)
    scans = [ht.scan_from_ranges(r, cfg.map.level_scale(0), laser,
                                 cfg.max_beams, device=dev) for r in ranges]
    state = ht.init_state(cfg, device=dev)
    for sc, pose in zip(scans, poses):
        state, _ = ht.slam_step(state, sc, cfg, pose_hint=torch.from_numpy(
            pose).to(dev), map_without_matching=True)
    rng = np.random.default_rng(17)
    hyp = (poses[-1] + rng.normal(0, 0.05, (4096, 3))).astype(np.float32)
    return cfg, state, scans[-1], torch.from_numpy(hyp).to(dev)


def _tutorial_level(cfg, state, scan, hyp, level):
    """The level's grid, scan and map-frame start estimates: the
    hypotheses, every fourth from the third moved to the map's left edge
    (most beams leave the map; singular Hessians send some to NaN), and
    the second on an unmapped patch (H = 0: the guard fails)."""
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.core.matcher import level_points
    size = cfg.map.size_x >> level
    est = world_to_map_pose(hyp, cfg.map.top_left_offset,
                            cfg.map.level_scale(level)).contiguous()
    est[2::4, 0] = 0.5
    est[1, :2] = size - 40.0
    return (state.quads[level].contiguous(), (size, size), est,
            level_points(scan.points, level).contiguous(),
            scan.mask.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 256, 4096])
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_level_form_bit_equal_to_step_route_on_card(tutorial_map, b, level,
                                                    masked):
    """interp_moments_level (one launch) against ``steps`` calls of
    gn_step_kernel (a moments launch, then the torch epilogue) on the
    card: the estimates and the last step's H bit for bit, on both levels
    of a mapped tutorial-sized pyramid, with an all-masked scan, hypotheses
    at the map's edge and one on an unmapped patch."""
    from hector_slam_tpu_torch.parallel.kernel_match import gn_step_kernel
    cfg, state, scan, hyp = tutorial_map
    quad, shape, est, pts, mask = _tutorial_level(cfg, state, scan, hyp,
                                                  level)
    est = est[:b].contiguous()
    if masked:
        mask = torch.zeros_like(mask)
    steps = (cfg.match.iterations_finest if level == 0
             else cfg.match.iterations_coarse) + 1
    mom0, lvl0 = im.interp_moments.launches, im.interp_moments_level.launches
    got = im.interp_moments_level(quad, shape, est, pts, mask, steps)
    assert im.interp_moments_level.launches == lvl0 + 1
    assert im.interp_moments.launches == mom0
    want, hess = est, None
    for _ in range(steps):
        want, hess = gn_step_kernel(quad, shape, want, pts, mask)
    assert _bits_equal(got[0], want) and _bits_equal(got[1], hess)
    again = im.interp_moments_level(quad, shape, est, pts, mask, steps)
    assert _bits_equal(again[0], got[0]) and _bits_equal(again[1], got[1])
    if masked:
        assert torch.equal(got[0], est) and not got[1].any()
        return
    if b > 1:   # the unmapped patch
        assert not got[1][1].any() and torch.equal(got[0][1], est[1])
    if b == 4096:   # the hypotheses about the pose converge
        assert bool(torch.isfinite(got[0][::4]).all())
        assert float((got[0] != est)[::4].any(-1).float().mean()) > 0.99


@pytest.mark.cuda
def test_kernel_route_replay_launches_once_a_level_on_card(tutorial_map):
    """One replay of match_hypotheses_kernel_jit launches the level form
    once a level and the moments-only form never; its poses are bit-equal
    to the eager matcher's and to the per-step route's."""
    from hector_slam_tpu_torch.core import graphs
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.core.matcher import finish_level, level_points
    from hector_slam_tpu_torch.parallel.kernel_match import gn_step_kernel
    cfg, state, scan, hyp = tutorial_map
    graphs.clear()
    eager, _ = ht.match_hypotheses_kernel(state.log_odds, hyp, scan, cfg,
                                          quads=state.quads)
    ht.match_hypotheses_kernel_jit(state.log_odds, hyp, scan, cfg,
                                   quads=state.quads)
    [entry] = graphs.stats()
    assert entry.per_replay == {"interp_moments": 0,
                                "interp_moments_level": cfg.map.levels,
                                "robot_match_level": 0,
                                "paint_cells": 0, "raster_paint": 0,
                                "map_tail": 0}
    mom0, lvl0 = im.interp_moments.launches, im.interp_moments_level.launches
    got, _ = ht.match_hypotheses_kernel_jit(state.log_odds, hyp, scan, cfg,
                                            quads=state.quads)
    torch.cuda.synchronize()
    assert im.interp_moments_level.launches - lvl0 == cfg.map.levels
    assert im.interp_moments.launches == mom0
    assert _bits_equal(got.pose, eager.pose)
    assert _bits_equal(got.hessian, eager.hessian)
    poses = hyp
    for level in range(cfg.map.levels - 1, -1, -1):
        steps = (cfg.match.iterations_finest if level == 0
                 else cfg.match.iterations_coarse) + 1
        est = world_to_map_pose(poses, cfg.map.top_left_offset,
                                cfg.map.level_scale(level))
        pts = level_points(scan.points, level).contiguous()
        for _ in range(steps):
            est, hess = gn_step_kernel(state.quads[level],
                                       tuple(state.log_odds[level].shape),
                                       est, pts, scan.mask.contiguous())
        poses = finish_level(est, cfg.map.top_left_offset,
                             cfg.map.level_resolution(level))
    assert _bits_equal(got.pose, poses) and _bits_equal(got.hessian, hess)
    graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("num_cells,n", [(1024 * 1024, 65536), (4096, 1),
                                         (64 * 256 * 256, 3_000_000)])
def test_paint_matches_plain_on_card(cuda_device, num_cells, n):
    """Random in-range indices, the sentinel num_cells, and duplicates:
    the kernel's grid equals the plain version's exactly, a second
    launch is bit-identical, and the bare launch is counted too."""
    rng = np.random.default_rng(36)
    flat = rng.integers(0, num_cells, n).astype(np.int32)
    flat[rng.random(n) < 0.3] = num_cells
    flat[: n // 4] = flat[n // 4: 2 * (n // 4)]
    idx = torch.from_numpy(flat).to(cuda_device)
    before = pc.paint_cells.launches
    got = pc.paint_cells(idx, num_cells)
    assert pc.paint_cells.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (num_cells,)
    assert torch.equal(got, pc.paint_cells_plain(idx, num_cells))
    assert torch.equal(got, pc.paint_cells(idx, num_cells))
    before = pc.paint_cells.launches
    grid = torch.zeros(num_cells, dtype=torch.bool, device=cuda_device)
    pc._launch([idx], [num_cells], grid)
    assert pc.paint_cells.launches == before + 1 and torch.equal(grid, got)


def _table(dev, rng, sizes, lengths):
    """One random index set per grid: in-range indices, 30% sentinels,
    a quarter duplicated."""
    flats = []
    for n, length in zip(sizes, lengths):
        f = rng.integers(0, n, length).astype(np.int32)
        f[rng.random(length) < 0.3] = n
        f[: length // 4] = f[length // 4: 2 * (length // 4)]
        flats.append(torch.from_numpy(f).to(dev))
    return flats


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [
    [746_497, 1152, 377_857, 1153, 193_537, 1151],   # a scan's six sets
    [5, 0, 1, 2, 3, 4, 7, 4099],                     # eight, one empty
    [47_775_744]])                                   # a fleet's L0 set
@pytest.mark.parametrize("offset", [0, 1])
def test_paint_sets_match_plain_on_card(cuda_device, lengths, offset):
    """Set tables held exactly to the plain version: 16-byte aligned
    sets and sets one index off (``flat[1:]``: a scalar head), lengths
    not a multiple of 4, an empty set, eight sets. One launch per table,
    and a repeat is bit-identical."""
    rng = np.random.default_rng(41)
    sizes = [(1 << 20, 1 << 18, 1 << 16)[k % 3] * (64 if len(lengths) == 1
                                                   else 1)
             for k in range(len(lengths))]
    flats = [f[offset:] for f in _table(cuda_device, rng, sizes,
                                        [n + offset for n in lengths])]
    assert all(f.data_ptr() % 16 == 4 * offset for f in flats if f.numel())
    before = pc.paint_cells.launches
    got = pc.paint_cell_sets(flats, sizes)
    assert pc.paint_cells.launches == before + 1
    want = pc.paint_cell_sets_plain(flats, sizes)
    for g, w, n in zip(got, want, sizes):
        assert g.dtype == torch.bool and g.shape == (n,)
        assert torch.equal(g, w)
    again = pc.paint_cell_sets(flats, sizes)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert pc.paint_cells.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("table", [
    [(64, 4099)], [(256, 4099)],
    [(64, 16 * 64)], [(64, 16 * 64 - 1)],            # at and below 16/cell
    [(64, 4099), (1 << 16, 5001), (256, 16 * 256)]])  # mixed in one launch
@pytest.mark.parametrize("offset", [0, 1])
def test_paint_read_first_sets_match_plain_on_card(cuda_device, table,
                                                   offset):
    """Sets of at least 16 index slots per cell take the kernel's
    read-first branch (kReadFirstSlotsPerCell), others store blindly:
    every set, aligned or with a scalar head (``flat[1:]``) and a tail,
    equals the plain version exactly. The indices name only even cells,
    with sentinels and negative indices among them, so half of every
    grid must stay False."""
    rng = np.random.default_rng(43)
    sizes = [cells for cells, _ in table]
    flats = []
    for cells, n in table:
        f = 2 * rng.integers(0, cells // 2, n + offset).astype(np.int32)
        f[rng.random(n + offset) < 0.3] = cells
        f[rng.random(n + offset) < 0.05] = -3
        flats.append(torch.from_numpy(f).to(cuda_device)[offset:])
    assert all(f.data_ptr() % 16 == 4 * offset for f in flats)
    before = pc.paint_cells.launches
    got = pc.paint_cell_sets(flats, sizes)
    assert pc.paint_cells.launches == before + 1
    for g, w in zip(got, pc.paint_cell_sets_plain(flats, sizes)):
        assert torch.equal(g, w) and not g[1::2].any()
    again = pc.paint_cell_sets(flats, sizes)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_paint_sets_count_one_launch_per_eight_sets(cuda_device):
    """Nine sets take two launches; a table of empty sets takes none."""
    rng = np.random.default_rng(42)
    sizes = [4096] * 9
    flats = _table(cuda_device, rng, sizes, [100] * 9)
    before = pc.paint_cells.launches
    got = pc.paint_cell_sets(flats, sizes)
    assert pc.paint_cells.launches == before + 2
    for g, w in zip(got, pc.paint_cell_sets_plain(flats, sizes)):
        assert torch.equal(g, w)
    empty = [f[:0] for f in flats[:3]]
    assert not any(g.any() for g in pc.paint_cell_sets(empty, sizes[:3]))
    assert pc.paint_cells.launches == before + 2


@pytest.mark.cuda
def test_paint_drops_out_of_range_on_card(cuda_device):
    """Indices outside [0, num_cells) are dropped, negative ones too (the
    plain version drops them as well, where a bare index_put_ wraps)."""
    idx = torch.tensor([3, 3, 0, 9, 10, 11, -1, -10, 2 ** 31 - 1],
                       dtype=torch.int32, device=cuda_device)
    got = pc.paint_cells(idx, 10).cpu().numpy()
    want = np.zeros(10, bool)
    want[[0, 3, 9]] = True
    np.testing.assert_array_equal(got, want)
    assert not pc.paint_cells(idx[:0], 10).any()
    with pytest.raises(TypeError):
        pc.paint_cells(idx.long(), 10)
    with pytest.raises(ValueError):
        pc.paint_cells(idx.reshape(3, 3).t(), 10)


@pytest.mark.cuda
def test_fleet_equals_single_robot_steps_on_card(cuda_device):
    """Four robots on their own corridor trajectories through fleet_step
    (one batched step, one raster_paint launch for every set and level)
    and each alone through slam_step: poses, gates and maps bit-equal."""
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=256,
                                         size_y=256, levels=2),
                        max_ray_cells=256)
    laser = ht.LaserModel()
    world = World.corridor(length=10.0, width=3.0)
    r, steps = 4, 6
    ranges = []
    for i in range(r):
        poses = np.zeros((steps, 3), np.float32)
        poses[:, 0] = 0.6 * i + np.arange(steps) * (0.05 + 0.02 * i)
        ranges.append(simulate_trajectory(world, poses, laser,
                                          range_noise_std=0.005, seed=i))
    ranges = np.stack(ranges, 1)

    def scan(rg):
        return ht.scan_from_ranges(rg, cfg.map.level_scale(0), laser,
                                   cfg.max_beams, device=cuda_device)

    fleet = ht.init_fleet(cfg, r, device=cuda_device)
    solo = [ht.init_state(cfg, device=cuda_device) for _ in range(r)]
    before = raster_paint.launches
    for t in range(steps):
        fleet, m = ht.fleet_step(fleet, ht.stack_scans(
            [scan(rg) for rg in ranges[t]]), cfg)
        for i in range(r):
            solo[i], sm = ht.slam_step(solo[i], scan(ranges[t, i]), cfg)
            assert bool(sm.map_updated) == bool(m.map_updated[i])
    assert raster_paint.launches == before + steps * (1 + r)
    for i in range(r):
        assert torch.equal(fleet.pose[i], solo[i].pose)
        for a, b in zip(fleet.log_odds, solo[i].log_odds):
            assert torch.equal(a[i], b)


def _counted(fn, *args):
    """fn(*args) once on the card, asserting it launched its kernel once."""
    before = fn.launches
    out = fn(*args)
    assert fn.launches == before + 1
    return out


# the six take_along probe workloads (tools/probe_pallas.py gather_tiles
# and gather_big): shape, axis, tile_rows
TAKE_ALONG_PROBES = [((512, 128), 1, 8), ((512, 128), 0, 8),
                     ((32, 256), 1, None), ((32, 256), 0, None),
                     ((32, 128), 1, None), ((8, 256), 1, None)]


def tiny_term_inputs(case, axis):
    """Inputs where take_along's ``acc[0] * 1e-30`` term changes the
    result (f32 p, i32 idx, tile_rows): ``zero_tiles``, 4 [8,128] tiles
    whose tiles 1-3 are all 0 (they sum only the term); ``half_zero``, one
    [32,128] tile with half of its entries exactly 0."""
    rng = np.random.default_rng(69)
    p = rng.random((32, 128), dtype=np.float32)
    if case == "zero_tiles":
        p[8:] = 0.0
        tile_rows = 8
    else:
        p[rng.random(p.shape) < 0.5] = 0.0
        tile_rows = None
    mod = ((tile_rows or 32), 128)[axis]
    return p, rng.integers(0, mod, p.shape).astype(np.int32), tile_rows


TINY_TERM_CASES = [("zero_tiles", 1), ("zero_tiles", 0), ("half_zero", 1),
                   ("half_zero", 0)]


def _corridor_scans(dev, cfg, steps=4):
    """A corridor drive with the 271-beam laser of the seg tests of
    tests/test_mapping.py: (poses f32[steps, 3], scans on ``dev``)."""
    laser = ht.LaserModel(num_beams=271, angle_min=-2.356,
                          angle_increment=4 * 0.004363, range_min=0.1,
                          range_max=12.0)
    poses = np.zeros((steps, 3), np.float32)
    poses[:, 0] = np.arange(steps) * 0.06
    poses[:, 1] = 0.03 * np.sin(np.arange(steps))
    ranges = simulate_trajectory(World.corridor(length=8.0, width=3.0),
                                 poses, laser, range_noise_std=0.0)
    return poses, [ht.scan_from_ranges(r, cfg.map.level_scale(0), laser,
                                       cfg.max_beams, device=dev)
                   for r in ranges]


@pytest.mark.cuda
@pytest.mark.parametrize("k_cap", [256, 40])
@pytest.mark.parametrize("budget", [0, 4])
def test_seg_sets_equal_dense_sets_on_card(cuda_device, k_cap, budget):
    """The segment-compacted free set painted by the kernel equals the
    dense one, inside the budget and past it (budget 4: every scan takes
    the dense fallback), with truncation (k_cap 40) and without; the
    occupied sets and truncated counts too, and both equal the CPU's."""
    from hector_slam_tpu_torch.core import mapping as tmap
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=256,
                                         size_y=256, levels=1),
                        max_ray_cells=256)
    poses, scans = _corridor_scans(cuda_device, cfg)
    for pose, sc in zip(poses, scans):
        args = ((256, 256), torch.from_numpy(pose).to(cuda_device),
                sc.points, sc.origo, sc.mask, cfg.map.top_left_offset,
                cfg.map.level_scale(0), k_cap)
        *_, total, cap = tmap.seg_cell_indices(*args, budget_segments=budget)
        assert (int(total) > cap) == (budget == 4)
        seg = tmap.rasterize_scan_seg(*args, budget_segments=budget)
        dense = tmap.rasterize_scan(*args)
        cpu = tmap.rasterize_scan_seg(*(a.cpu() if torch.is_tensor(a) else a
                                        for a in args),
                                      budget_segments=budget)
        for a, b, c in zip(seg, dense, cpu):
            assert torch.equal(a, b)
            assert torch.equal(a.cpu(), c)
        assert seg[0].any() and seg[1].any()


@pytest.mark.cuda
def test_slam_step_paints_seg_sets_on_card(cuda_device, monkeypatch):
    """On the card slam_step paints whichever free-set layout it is given
    (None: "seg", "seg", "xla") with one raster_paint launch a scan and
    builds no index set (paint_cell_sets is never called), and its maps
    equal the CPU's compacted ("seg") and dense routes, which paint the
    index sets."""
    from hector_slam_tpu_torch.core import mapping as tmap
    from hector_slam_tpu_torch.ops.raster_paint import raster_paint
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=256,
                                         size_y=256, levels=2),
                        max_ray_cells=256)
    poses, scans = _corridor_scans(cuda_device, cfg)
    shapes = []
    paint = tmap.paint_cell_sets

    def spy(flats, sizes):
        shapes.append([tuple(f.shape) for f in flats])
        return paint(flats, sizes)

    monkeypatch.setattr(tmap, "paint_cell_sets", spy)
    states = {}
    for backend, dev in ((None, cuda_device), ("seg", cuda_device),
                         ("xla", cuda_device), (None, torch.device("cpu")),
                         ("seg", torch.device("cpu"))):
        state = ht.init_state(cfg, device=dev)
        before = (pc.paint_cells.launches, raster_paint.launches)
        for pose, sc in zip(poses, scans):
            state, _ = ht.slam_step(
                state, ht.Scan(*(f.to(dev) for f in sc)), cfg,
                pose_hint=torch.from_numpy(pose).to(dev),
                map_without_matching=True, raster_backend=backend)
        if dev.type == "cuda":
            assert (pc.paint_cells.launches, raster_paint.launches) == (
                before[0], before[1] + len(poses))
            assert not shapes
        states[(backend, dev.type)] = state
    dense_shapes, seg_shapes = shapes[:len(poses)], shapes[len(poses):]
    slots = [tmap.seg_budget(cfg.max_beams, k)[1] * 64 + cfg.max_beams * k
             for k in map(cfg.level_max_ray_cells, range(cfg.map.levels))]
    assert all(sets[0::2] == [(n,) for n in slots] for sets in seg_shapes)
    assert all(sets[0][1] == cfg.level_max_ray_cells(0)
               for sets in dense_shapes)
    seg = states[(None, "cuda")]
    for other in (states[("seg", "cuda")], states[("xla", "cuda")],
                  states[(None, "cpu")], states[("seg", "cpu")]):
        for a, b in zip(seg.log_odds, other.log_odds):
            assert torch.equal(a.cpu(), b.cpu())


def sum_order_inputs(mode):
    """A 256^2 grid of 2**24 and 1.0 values, where any other order of a
    patch element's adds rounds differently, and in-range tables (the
    probe's): (g, ys, xs), patch (32, 128), 40 reps."""
    rng = np.random.default_rng(70 + dsl.MODES.index(mode))
    g = np.where(rng.random((256, 256)) < 0.5, 2.0 ** 24, 1.0).astype(
        np.float32)
    ys = rng.integers(0, 256 - 32, dsl.OFFSETS).astype(np.int32)
    xs = rng.integers(0, 256 - 128, dsl.OFFSETS).astype(np.int32)
    return g, ys, xs


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis,tile_rows,reps", [
    *[(s, a, t, (0, 1, 13, 512)) for s, a, t in TAKE_ALONG_PROBES],
    ((12, 5), 0, 3, (0, 1, 13)), ((12, 5), 1, 3, (0, 1, 13)),
    ((6, 100), 1, 3, (1, 13)), ((200, 3), 0, 100, (1, 13)),
    ((40, 33), 1, 20, (13,)), ((8192, 32), 1, None, (13,))])
def test_take_along_matches_plain_on_card(cuda_device, shape, axis,
                                          tile_rows, reps):
    """The six probe workloads up to their high rep count (512), the odd
    tilings (3-row tiles of 5 columns: lines shorter than a warp and not
    dividing it; lines of 100 and 33: not a multiple of 32) and 8,192
    lines of one tile (more warps than fit one per block); indices beyond
    the axis and negative, which wrap as Python's modulo."""
    rng = np.random.default_rng(37)
    th = shape[0] if tile_rows is None else tile_rows
    mod = (th, shape[1])[axis]
    p = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-2 * mod, 3 * mod, shape).astype(
        np.int32)).to(cuda_device)
    for r in reps:
        got = _counted(ta.take_along, p, idx, r, axis, tile_rows)
        want = ta.take_along_plain(p, idx, r, axis, tile_rows)
        assert torch.equal(got, want)
        assert torch.equal(got, ta.take_along(p, idx, r, axis, tile_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("case,axis", TINY_TERM_CASES)
def test_take_along_keeps_the_tiny_term_on_card(cuda_device, case, axis):
    """tiny_term_inputs (where dropping the 1e-30 term changes the
    result, tests/test_torch_probes.py) at 64 reps: equal to the plain
    version."""
    p, idx, tile_rows = (torch.from_numpy(v).to(cuda_device) if
                         isinstance(v, np.ndarray) else v
                         for v in tiny_term_inputs(case, axis))
    got = _counted(ta.take_along, p, idx, 64, axis, tile_rows)
    assert torch.equal(got, ta.take_along_plain(p, idx, 64, axis, tile_rows))


@pytest.mark.cuda
def test_take_along_refuses_a_long_line_on_card(cuda_device):
    """A line past MAX_LINE is refused before any launch, as on the
    CPU."""
    n = ta.MAX_LINE + 1
    p = torch.zeros(2, n, device=cuda_device)
    idx = torch.zeros(2, n, dtype=torch.int32, device=cuda_device)
    before = ta.take_along.launches
    with pytest.raises(ValueError, match=f"at most {ta.MAX_LINE}"):
        ta.take_along(p, idx, 1, 1)
    assert ta.take_along.launches == before
    # the other axis is 2 long: any number of lines is taken
    assert torch.equal(ta.take_along(p, idx, 3, 0),
                       ta.take_along_plain(p, idx, 3, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("line", [257, 1024, ta.MAX_LINE])
@pytest.mark.parametrize("axis", [1, 0])
def test_take_along_long_lines_match_plain_on_card(cuda_device, line, axis):
    """Lines longer than a warp's 256 (the kernel's block path) up to
    MAX_LINE, on both axes, in 3 tiles (tiles 1 and 2 recompute tile 0's
    line beside their own): equal to the plain version at reps 0, 1, 13
    and 300 (past 257 the gathered position wraps the line), indices
    beyond the axis and negative."""
    rng = np.random.default_rng(44)
    th, tw = (2, line) if axis == 1 else (line, 3)
    shape = (3 * th, tw)
    p = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-2 * line, 3 * line, shape).astype(
        np.int32)).to(cuda_device)
    for r in (0, 1, 13, 300):
        got = _counted(ta.take_along, p, idx, r, axis, th)
        assert torch.equal(got, ta.take_along_plain(p, idx, r, axis, th))
        assert torch.equal(got, ta.take_along(p, idx, r, axis, th))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", dsl.MODES)
@pytest.mark.parametrize("grid,patch,reps,spread", [
    ((256, 256), (32, 128), (0, 1, 600), 300),    # offsets beyond the edge
    ((1024, 1024), (32, 128), (1024, 16384), 0),  # the probe's workload
    ((256, 256), (7, 100), (1, 600), 300),        # width not a multiple of 32
    ((256, 256), (3, 20), (17, 600), 300),        # narrower than a warp
    ((300, 1000), (40, 300), (513,), 1200)])      # a larger patch
def test_dyn_slice_matches_plain_on_card(cuda_device, mode, grid, patch, reps,
                                         spread):
    """Sums bit-equal to the plain version's. ``spread`` > 0: offsets in
    range, beyond the edge and negative, drawn from [-spread, spread);
    0: the probe's tables, in range. 600 reps wrap the 512-slot table."""
    rng = np.random.default_rng(38)
    g = torch.from_numpy(rng.random(grid, dtype=np.float32)).to(cuda_device)
    if spread:
        ys, xs = (rng.integers(-spread, spread, dsl.OFFSETS) for _ in "yx")
    else:
        ys = rng.integers(0, grid[0] - patch[0], dsl.OFFSETS)
        xs = rng.integers(0, grid[1] - patch[1], dsl.OFFSETS)
    ys, xs = (torch.from_numpy(v.astype(np.int32)).to(cuda_device)
              for v in (ys, xs))
    for r in reps:
        got = _counted(dsl.dyn_slice, g, ys, xs, r, patch, mode)
        assert torch.equal(got, dsl.dyn_slice_plain(g, ys, xs, r, patch,
                                                    mode))
        assert torch.equal(got, dsl.dyn_slice(g, ys, xs, r, patch, mode))
    with pytest.raises(ValueError):
        dsl.dyn_slice(g, ys[:100], xs[:100], 4, patch, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", dsl.MODES)
def test_dyn_slice_keeps_the_sum_order_on_card(cuda_device, mode):
    """sum_order_inputs (where a pairwise sum differs,
    tests/test_torch_probes.py): equal to the plain version."""
    g, ys, xs = (torch.from_numpy(v).to(cuda_device)
                 for v in sum_order_inputs(mode))
    got = _counted(dsl.dyn_slice, g, ys, xs, 40, (32, 128), mode)
    assert torch.equal(got, dsl.dyn_slice_plain(g, ys, xs, 40, (32, 128),
                                                mode))


def _probe_runs(dev, rng, n, h=1024, w=1024):
    """n runs drawn as tools/probe_mosaic_store.py draws them."""
    lo = rng.integers(0, 120, n)
    return [torch.from_numpy(c.astype(np.int32)).to(dev) for c in (
        rng.integers(0, h, n), rng.integers(0, w // 128, n) * 128, lo,
        np.minimum(lo + rng.integers(0, 8, n), 127))]


@pytest.mark.cuda
def test_paint_runs_matches_plain_on_card(cuda_device):
    """16,384 runs on 1024^2, the probe's workload: grids exactly equal,
    a second launch bit-identical, one launch per call (the kernel zeroes
    the grid itself), the bare launch counted too and writing every cell
    of a grid that held NaN; a run off its aligned segment is refused
    before any launch."""
    rng = np.random.default_rng(39)
    runs = _probe_runs(cuda_device, rng, 16 * 1024)
    got = _counted(pr.paint_runs, *runs, (1024, 1024))
    assert torch.equal(got, pr.paint_runs_plain(*runs, (1024, 1024)))
    assert torch.equal(got, pr.paint_runs(*runs, (1024, 1024)))
    assert 0 < int(got.sum()) <= int((runs[3] - runs[2] + 1).sum())
    before = pr.paint_runs.launches
    grid = torch.full((1024, 1024), float("nan"), device=cuda_device)
    pr._launch(*runs, grid)
    assert pr.paint_runs.launches == before + 1 and torch.equal(grid, got)
    before = pr.paint_runs.launches
    runs[1][5] = 64
    with pytest.raises(ValueError, match="run 5"):
        pr.paint_runs(*runs, (1024, 1024))
    assert pr.paint_runs.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [((1024, 1024), 4096), ((3, 384), 5000),
                                     ((1, 128), 0), ((1000, 256), 1)])
def test_paint_runs_one_segment_and_odd_grids_on_card(cuda_device, shape, n):
    """Every run on one [1, 128] segment (row 1 % h, c0 = 128 % w: all
    stores to the same few lines), grids whose cell count is not a
    multiple of 4 or of the threads, no runs at all: exactly the plain
    version, one launch per call."""
    h, w = shape
    rng = np.random.default_rng(45)
    lo = rng.integers(0, 128, n)
    runs = [torch.from_numpy(c.astype(np.int32)).to(cuda_device) for c in (
        np.full(n, 1 % h), np.full(n, 128 % w), lo,
        np.minimum(lo + rng.integers(0, 8, n), 127))]
    got = _counted(pr.paint_runs, *runs, shape)
    assert torch.equal(got, pr.paint_runs_plain(*runs, shape))
    assert torch.equal(got, pr.paint_runs(*runs, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 80, 8192])
def test_matmul_stationary_matches_plain_on_card(cuda_device, m):
    """The probe's operands (a ~ U(0, 0.1), w ~ U(0, 0.01)) at reps 0, 1,
    8, 64 and MM_DENORMAL_REPS (every value denormal), m a whole number of
    64-row tiles or not (16, 80): within MM_ULPS bf16 ulps of the plain
    version, a second launch bit-identical."""
    rng = np.random.default_rng(40)
    a = torch.from_numpy((rng.random((m, 128)) * 0.1).astype(
        np.float32)).to(cuda_device).to(torch.bfloat16)
    w = torch.from_numpy((rng.random((128, 128)) * 0.01).astype(
        np.float32)).to(cuda_device).to(torch.bfloat16)
    for reps in (0, 1, 8, 64, MM_DENORMAL_REPS):
        got = _counted(mms.matmul_stationary, a, w, reps)
        want = mms.matmul_stationary_plain(a, w, reps)
        assert float(mms.bf16_ulps(got, want).max()) <= MM_ULPS
        assert torch.equal(got, mms.matmul_stationary(a, w, reps))
    assert float(want.abs().max()) < 2.0 ** -126
    assert float(want.abs().min()) >= 2 * 2.0 ** -133
    with pytest.raises(ValueError):
        mms.matmul_stationary(a[:, :64].contiguous(), w, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 4])
def test_matmul_stationary_takes_unaligned_operands_on_card(cuda_device,
                                                            offset):
    """a and w as views ``offset`` bf16 (2 or 8 bytes) into larger buffers,
    so neither starts on a 16-byte boundary: the same result as the same
    values at aligned addresses, within MM_ULPS of the plain version, and
    the views left unchanged."""
    rng = np.random.default_rng(41)
    m, reps = 80, 8
    vals = [torch.from_numpy((rng.random(shape) * scale).astype(
        np.float32)).to(cuda_device).to(torch.bfloat16)
        for shape, scale in (((m, 128), 0.1), ((128, 128), 0.01))]
    views = []
    for v in vals:
        buf = torch.zeros(v.numel() + offset, dtype=torch.bfloat16,
                          device=cuda_device)
        buf[offset:] = v.reshape(-1)
        views.append(buf[offset:].view(v.shape))
    a, w = views
    assert a.data_ptr() % 16 and w.data_ptr() % 16
    got = _counted(mms.matmul_stationary, a, w, reps)
    assert torch.equal(got, mms.matmul_stationary(*vals, reps))
    want = mms.matmul_stationary_plain(*vals, reps)
    assert float(mms.bf16_ulps(got, want).max()) <= MM_ULPS
    assert all(torch.equal(x, v) for x, v in zip(views, vals))


@pytest.mark.cuda
def test_recovery_selection_on_card_matches_cpu(cuda_device):
    """The recovery's selections on CUDA tensors pick what they pick on
    the CPU: ties by lower index, NaN after every number (the stable
    sort), and the first NaN for the row argmin."""
    from hector_slam_tpu_torch.parallel import recovery as rec
    rng = np.random.default_rng(43)
    s = rng.integers(0, 6, 1024).astype(np.float32)
    s[[3, 133, 700]] = np.nan
    hyp = np.arange(1024 * 3, dtype=np.float32).reshape(1024, 3)
    for k in (256, 100):
        got = rec._select_top(torch.from_numpy(hyp).to(cuda_device),
                              torch.from_numpy(s).to(cuda_device), k)
        want = rec._select_top(torch.from_numpy(hyp), torch.from_numpy(s), k)
        assert torch.equal(got.cpu(), want)
    rows = torch.from_numpy(s.reshape(8, 128))
    assert torch.equal(rec._argmin_first(rows.to(cuda_device)).cpu(),
                       rec._argmin_first(rows))


@pytest.mark.cuda
def test_session_relocalize_on_card_matches_cpu(cuda_device):
    """A kidnapped session on the card recovers through the moments kernel
    (prune, then cascade_refine_jit's graph: one launch of the level form
    on each of two levels, counted once more in its first call's warm-up) as the same
    session on the CPU does through the kernel's plain version: the same
    acceptance, winners within 5 mm and 0.005 rad."""
    from hector_slam_tpu_torch.io.simulator import corridor_trajectory
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=256,
                                         size_y=256, levels=2),
                        max_beams=192, max_ray_cells=256)
    laser = ht.LaserModel(num_beams=181, angle_min=-1.57,
                          angle_increment=np.pi / 180, range_min=0.1,
                          range_max=8.0)
    ranges = simulate_trajectory(World.corridor(length=10.0, width=3.0),
                                 corridor_trajectory(20, advance=0.05,
                                                     weave=0.02),
                                 laser, range_noise_std=0.003)
    card = ht.SlamSession(cfg, laser)
    for r in ranges:
        card.process_ranges(r)
    cpu = ht.SlamSession(cfg, laser, device="cpu")
    cpu.state = ht.state_from_numpy(
        [lo.cpu().numpy() for lo in card.state.log_odds], card.pose,
        card.state.last_map_update_pose.cpu().numpy(), card.covariance,
        int(card.state.step), int(card.state.map_update_count), cfg,
        device="cpu")
    good = card.pose.copy()
    shift = np.asarray([0.6, -0.5, 0.25], np.float32)
    card.state = card.state._replace(pose=torch.from_numpy(
        good + shift).to(cuda_device))
    cpu.state = cpu.state._replace(pose=torch.from_numpy(good + shift))
    kw = dict(n_hypotheses=1024, sigma_xy=0.6, sigma_theta=0.3, seed=3,
              method="pallas")
    before = im.interp_moments.launches
    level0 = im.interp_moments_level.launches
    got = card.relocalize(**kw)
    # cascade_refine_jit's first call: its warm-up and one replay, each one
    # level launch for each of the two levels
    assert im.interp_moments_level.launches - level0 == 2 + 2
    assert im.interp_moments.launches == before
    want = cpu.relocalize(scan=ht.scan_from_ranges(
        ranges[-1], cfg.map.level_scale(0), laser, cfg.max_beams,
        device="cpu"), **kw)
    assert got["accepted"] and want["accepted"]
    assert np.linalg.norm(got["pose"][:2] - want["pose"][:2]) < 5e-3
    assert abs(float(got["pose"][2] - want["pose"][2])) < 5e-3
    assert np.linalg.norm(got["pose"][:2] - good[:2]) < 0.1


@pytest.mark.cuda
def test_raycast_batch_on_card_matches_cpu(cuda_device):
    """distance_to_obstacle_batch on the card and on the CPU, on the same
    map and rays: the same cell distances, exactly (integer cells; the
    one float op, sqrt then floor, is correctly rounded on both)."""
    rng = np.random.default_rng(41)
    g = np.where(rng.uniform(size=(512, 384)) < 0.02, 100,
                 rng.choice([-1, 0], (512, 384))).astype(np.int8)
    begins = rng.integers(-8, 520, (16384, 2)).astype(np.int32)
    ends = rng.integers(-8, 520, (16384, 2)).astype(np.int32)
    card = ht.distance_to_obstacle_batch(g, begins, ends, max_cells=600)
    assert card.device.type == "cuda"
    cpu = ht.distance_to_obstacle_batch(g, begins, ends, max_cells=600,
                                        device="cpu")
    assert torch.equal(card.cpu(), cpu)
    assert int((cpu >= 0).sum()) > 1000 and int((cpu < 0).sum()) > 1000


@pytest.mark.cuda
def test_checkpoint_written_on_card_loads_on_cpu(cuda_device, tmp_path):
    """A fleet state on the card through save_state, load_state on the CPU
    (and back onto the card): every leaf bit-equal, the quads recomputed
    from the levels equal to the card's own."""
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=256,
                                         size_y=256, levels=2),
                        max_beams=1152, max_ray_cells=256)
    laser = ht.LaserModel()
    ranges = simulate_trajectory(World.room(size=10.0),
                                 np.zeros((3, 3), np.float32), laser)
    scans = ht.stack_scans([ht.scan_from_ranges(r, cfg.map.level_scale(0),
                                                laser, cfg.max_beams)
                            for r in ranges])
    fleet, _ = ht.fleet_step(ht.init_fleet(cfg, 3), scans, cfg)
    path = str(tmp_path / "fleet.npz")
    ht.save_state(path, fleet)
    template = ht.init_fleet(cfg, 3, device="cpu")
    cpu = ht.load_state(path, cfg, template=template, device="cpu")
    back = ht.load_state(path, cfg, template=template)
    for state in (cpu, back):
        for got, want in zip((*state.log_odds, *state[1:6]),
                             (*fleet.log_odds, *fleet[1:6])):
            assert torch.equal(got.cpu(), want.cpu())
    assert back.pose.device.type == "cuda"
    for got, want in zip(back.quads, fleet.quads):
        assert torch.equal(got, want)
    assert int((cpu.log_odds[0] > 0).sum()) > 100


# ---- compiled entry points: CUDA graphs (core/graphs.py) -----------------

GRAPH_SCANS = 40


def _fixture_scans(dev, n=GRAPH_SCANS):
    """The first ``n`` scans of the corridor fixture at BENCH_CONFIG, as a
    stacked log and one by one, on ``dev``."""
    import os
    cfg = ht.BENCH_CONFIG
    ranges, laser, _ = ht.load_log(os.path.join(
        os.path.dirname(__file__), "fixtures", "corridor_utm30lx.npz"))
    log = ht.stack_scans([ht.scan_from_ranges(
        r, cfg.map.level_scale(0), laser, cfg.max_beams, device=dev)
        for r in ranges[:n]])
    return log, [ht.Scan(log.points[t], log.origo[t], log.mask[t])
                 for t in range(n)]


@pytest.mark.cuda
def test_slam_step_jit_replays_bit_equal_to_slam_step_on_card(cuda_device):
    """A graphed slam_step_jit (the update on every scan, the gate and the
    seg fallback decided on the card) against its body, slam_step, run
    eagerly: poses, metrics and every state leaf bit-equal scan by scan;
    the donated state updated in place; run_log_jit bit-equal to both."""
    from hector_slam_tpu_torch.core import graphs
    cfg = ht.BENCH_CONFIG
    log, scans = _fixture_scans(cuda_device)
    eager = ht.init_state(cfg, device=cuda_device)
    jit = ht.init_state(cfg, device=cuda_device)
    maps = [t.data_ptr() for t in jit.log_odds + jit.quads]
    gates = []
    for sc in scans:
        eager, me = ht.slam_step(eager, sc, cfg)
        jit, mj = ht.slam_step_jit(jit, sc, cfg)
        for a, b in zip(me, mj):
            assert torch.equal(a, b)
        assert torch.equal(eager.pose, jit.pose)
        gates.append(bool(me.map_updated))
    assert 3 < sum(gates) < GRAPH_SCANS
    assert [t.data_ptr() for t in jit.log_odds + jit.quads] == maps
    for a, b in zip(eager, jit):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    start = ht.init_state(cfg, device=cuda_device)
    final, poses, metrics = ht.run_log_jit(start, log, cfg)
    assert torch.equal(final.log_odds[0], eager.log_odds[0])
    assert torch.equal(poses[-1], eager.pose)
    assert int(metrics.map_updated.sum()) == sum(gates)
    assert int(start.step) == 0          # run_log_jit does not donate
    assert [g.name for g in graphs.stats()][-2:] == ["slam_step_jit",
                                                     "run_log_jit"]


@pytest.mark.cuda
def test_graph_replays_make_no_stream_sync_on_card(cuda_device):
    """Once captured, slam_step_jit, the phase pair, run_log_jit and
    match_hypotheses_kernel_jit replay with torch's sync debug mode set
    to "error": no host read, no pageable copy, anywhere in a call."""
    cfg = ht.BENCH_CONFIG
    log, scans = _fixture_scans(cuda_device, 12)
    state = ht.init_state(cfg, device=cuda_device)
    phased = ht.init_state(cfg, device=cuda_device)
    hyp = torch.zeros((64, 3), device=cuda_device)
    from hector_slam_tpu_torch.core.slam import (match_phase_jit,
                                                 update_phase_jit)

    def calls(st, ph):
        for sc in scans[:4]:
            st, _ = ht.slam_step_jit(st, sc, cfg)
            pose, hess = match_phase_jit(ph, sc, cfg)
            ph, _ = update_phase_jit(ph, sc, cfg, pose, hess)
        ht.run_log_jit(st, log, cfg)
        ht.match_hypotheses_kernel_jit(st.log_odds, hyp, scans[0], cfg,
                                       quads=st.quads)
        return st, ph

    state, phased = calls(state, phased)          # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, phased = calls(state, phased)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(state.step) == 8 and int(phased.step) == 8


@pytest.mark.cuda
def test_graph_capture_failure_raises_on_card(cuda_device, monkeypatch):
    """A body that reads the card on the host works eagerly (the warm-up)
    but cannot be captured: slam_step_jit raises and returns nothing, no
    graph is kept, and the next capture of a sound body works."""
    from hector_slam_tpu_torch.core import graphs
    from hector_slam_tpu_torch.core import slam as slam_mod
    cfg = ht.SlamConfig(map=ht.MapConfig(size_x=128, size_y=128, levels=2),
                        max_ray_cells=128)
    _, scans = _fixture_scans(cuda_device, 2)
    scans = [ht.scan_from_numpy(sc.points.cpu().numpy() / 4,
                                sc.origo.cpu().numpy(),
                                sc.mask.cpu().numpy(), device=cuda_device)
             for sc in scans]
    det3 = slam_mod.det3
    monkeypatch.setattr(slam_mod, "det3",
                        lambda h: det3(h) * float(h.abs().sum() >= 0))
    graphs.clear()
    state = ht.init_state(cfg, device=cuda_device)
    with pytest.raises(RuntimeError, match="capture failed"):
        ht.slam_step_jit(state, scans[0], cfg)
    assert graphs.stats() == []
    assert int(state.step) == 0
    monkeypatch.setattr(slam_mod, "det3", det3)
    eager, me = ht.slam_step(ht.init_state(cfg, device=cuda_device),
                             scans[0], cfg)
    jit, mj = ht.slam_step_jit(state, scans[0], cfg)
    assert torch.equal(eager.pose, jit.pose) and torch.equal(
        eager.log_odds[0], jit.log_odds[0])


@pytest.mark.cuda
def test_graph_launch_counts_add_up_per_replay_on_card(cuda_device):
    """The kernel wrappers' counters count a graph's warm-up once and its
    captured launches at every replay: slam_step_jit matches with the
    robot kernel once a level, paints once a scan and launches the map
    tail's two kernels once a scan (both run on every scan; the tail's
    blocks return where the gate did not fire),
    match_hypotheses_kernel_jit launches the moments kernel's level form
    3 times a call at BENCH_CONFIG (once a level, its 14 GN steps inside)
    and the moments-only form never."""
    from hector_slam_tpu_torch.core import graphs
    from hector_slam_tpu_torch.ops.map_tail import map_tail
    cfg = ht.BENCH_CONFIG
    _, scans = _fixture_scans(cuda_device, 10)
    graphs.clear()
    paint0, mom0 = raster_paint.launches, im.interp_moments.launches
    level0, tail0 = im.interp_moments_level.launches, map_tail.launches
    state = ht.init_state(cfg, device=cuda_device)
    for sc in scans:
        state, _ = ht.slam_step_jit(state, sc, cfg)
    [step] = graphs.stats()
    assert step.per_replay == {"interp_moments": 0,
                               "interp_moments_level": 0,
                               "robot_match_level": cfg.map.levels,
                               "paint_cells": 0, "raster_paint": 1,
                               "map_tail": 2}
    assert step.warmup == {"interp_moments": 0, "interp_moments_level": 0,
                           "robot_match_level": cfg.map.levels,
                           "paint_cells": 0, "raster_paint": 1,
                           "map_tail": 2}
    assert step.replays == 10 and step.pool_bytes > 0
    assert raster_paint.launches - paint0 == 1 + 10
    assert map_tail.launches - tail0 == 2 * (1 + 10)
    hyp = state.pose + torch.zeros((256, 3), device=cuda_device)
    for _ in range(3):
        ht.match_hypotheses_kernel_jit(state.log_odds, hyp, scans[-1], cfg,
                                       quads=state.quads)
    assert graphs.stats()[-1].per_replay["interp_moments_level"] == 3
    assert graphs.stats()[-1].per_replay["interp_moments"] == 0
    assert im.interp_moments_level.launches - level0 == 3 + 3 * 3
    assert im.interp_moments.launches == mom0
    assert raster_paint.launches - paint0 == 11


# ---- the session's recoveries through compiled routes, reset, CLI --------


def _kidnap_inputs(dev, n=1024, seed=3):
    """A BENCH_CONFIG state after 40 fixture scans, its last scan, and
    ``relocalize``'s 1,024 theta-stratified draws around the pose shifted
    by (+0.6 m, -0.5 m, +0.25 rad), pruned to 256 on the card."""
    from hector_slam_tpu_torch.parallel import recovery as rec
    cfg = ht.BENCH_CONFIG
    log, scans = _fixture_scans(dev)
    state, _, _ = ht.run_log_jit(ht.init_state(cfg, device=dev), log, cfg)
    center = state.pose.cpu().numpy() + np.asarray([0.6, -0.5, 0.25],
                                                   np.float32)
    rng = np.random.default_rng(seed)
    thetas = center[2] + 0.3 * (-2.0 + 4.0 * (np.arange(n // 128) + 0.5)
                                / (n // 128))
    hyp = np.c_[center[0] + rng.normal(0, 0.6, n),
                center[1] + rng.normal(0, 0.6, n),
                np.repeat(thetas, 128)].astype(np.float32)
    hyp[0] = center
    pruned = rec.prune_hypotheses_coarse(
        state.log_odds, torch.from_numpy(hyp).to(dev), scans[-1], cfg, 256,
        quads=state.quads)
    return state, scans[-1], pruned


@pytest.mark.cuda
def test_recovery_graphs_bit_equal_to_eager_on_card(cuda_device):
    """cascade_refine_jit (one graph: three launches of the moments
    kernel's level form a replay, one a level)
    and residual_for_poses_jit (level 0 with the full scan, level 2 with
    the sweep's 8-strided one, each with and without the quads) on the card:
    bit-equal to their eager bodies, and their replays make no stream
    sync."""
    from hector_slam_tpu_torch.core import graphs
    from hector_slam_tpu_torch.parallel import batch
    from hector_slam_tpu_torch.parallel import recovery as rec
    cfg = ht.BENCH_CONFIG
    state, scan, hyp = _kidnap_inputs(cuda_device)
    graphs.clear()
    mom0 = im.interp_moments.launches
    level0 = im.interp_moments_level.launches
    want = rec.cascade_refine(state.log_odds, hyp, scan, cfg,
                              quads=state.quads)
    got = rec.cascade_refine_jit(state.log_odds, hyp, scan, cfg,
                                 quads=state.quads)
    assert all(torch.equal(a, b) for a, b in zip(want[0] + want[1],
                                                 got[0] + got[1]))
    [cascade] = graphs.stats()
    assert cascade.per_replay["interp_moments_level"] == 3
    assert cascade.per_replay["interp_moments"] == 0
    # eager, warm-up, one replay
    assert im.interp_moments_level.launches - level0 == 3 * 3
    assert im.interp_moments.launches == mom0
    sub = ht.Scan(scan.points[::8], scan.origo, scan.mask[::8])
    calls = []
    for level, sc in ((0, scan), (2, sub)):
        for quad in (state.quads[level], None):
            calls.append((state.log_odds[level], hyp, sc, cfg, quad, level))
            assert torch.equal(batch.residual_for_poses_jit(*calls[-1]),
                               batch.residual_for_poses(*calls[-1]))
    assert len(graphs.stats()) == 1 + len(calls)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = rec.cascade_refine_jit(state.log_odds, hyp, scan, cfg,
                                       quads=state.quads)
        for args in calls:
            batch.residual_for_poses_jit(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(again[0].pose, want[0].pose)
    assert graphs.stats()[0].replays == 2


@pytest.mark.cuda
@pytest.mark.parametrize("k_budget", [4096, 64])
def test_mxu_graph_bit_equal_to_eager_on_card(cuda_device, k_budget):
    """match_hypotheses_mxu_jit on the kidnap batch (256 pruned draws;
    most GN steps past the budget, some repaired at 64 as well): bit-equal
    to the eager matcher, 14 moments launches a replay (the full path on
    every GN step), no stream sync in a replay, and the same result under
    a float32 matmul precision of "high" (the patch selection is a
    gather)."""
    from hector_slam_tpu_torch.core import graphs
    cfg = ht.BENCH_CONFIG
    state, scan, hyp = _kidnap_inputs(cuda_device)
    graphs.clear()
    kw = dict(num_buckets=2, k_budget=k_budget, with_diag=True)
    want = ht.match_hypotheses_mxu(state.log_odds, hyp, scan, cfg, **kw)
    got = ht.match_hypotheses_mxu_jit(state.log_odds, hyp, scan, cfg, **kw)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert torch.equal(a, b)
    [entry] = graphs.stats()
    assert entry.per_replay["interp_moments"] == 14
    assert int(got[1].overflow_steps) > 0
    prev = torch.get_float32_matmul_precision()
    torch.cuda.synchronize()
    torch.set_float32_matmul_precision("high")
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = ht.match_hypotheses_mxu_jit(state.log_odds, hyp, scan, cfg,
                                            **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.set_float32_matmul_precision(prev)
    for a, b in zip(want[0] + want[1], again[0] + again[1]):
        assert torch.equal(a, b)
    assert graphs.stats()[0].replays == 2
    graphs.clear()


@pytest.mark.cuda
def test_session_reset_keeps_the_step_graph_on_card(cuda_device):
    """Three reset() calls, each followed by one scan: no new capture, no
    new reserved device memory, the state bit-equal to init_state's
    before the scan and the poses to a fresh session's after it."""
    from hector_slam_tpu_torch.core import graphs
    cfg = ht.BENCH_CONFIG
    _, scans = _fixture_scans(cuda_device, 6)
    sess = ht.SlamSession(cfg)
    for sc in scans:
        sess.process_scan(sc)
    fresh = ht.SlamSession(cfg)
    want = fresh.process_scan(scans[0])
    init = ht.init_state(cfg, device=cuda_device)
    torch.cuda.synchronize()
    captures = graphs.totals()["captures"]
    reserved = torch.cuda.memory_reserved()
    ptrs = [t.data_ptr() for t in sess.state.log_odds + sess.state.quads]
    for _ in range(3):
        sess.reset()
        assert all(torch.equal(a, b) for a, b in zip(
            sess.state.log_odds + sess.state.quads,
            init.log_odds + init.quads))
        np.testing.assert_array_equal(sess.process_scan(scans[0]), want)
        torch.cuda.synchronize()
        assert graphs.totals()["captures"] == captures
        assert torch.cuda.memory_reserved() == reserved
    assert [t.data_ptr() for t in sess.state.log_odds
            + sess.state.quads] == ptrs


@pytest.mark.cuda
def test_save_geotiff_cli_on_card(cuda_device, tmp_path):
    """python -m hector_slam_tpu_torch.save_geotiff on the card (its
    default device), from a checkpoint and from a log: the files equal
    those rendered on the CPU."""
    from hector_slam_tpu_torch.save_geotiff import main
    cfg = ht.BENCH_CONFIG
    log, _ = _fixture_scans(cuda_device, 12)
    state, _, _ = ht.run_log_jit(ht.init_state(cfg, device=cuda_device),
                                 log, cfg)
    ckpt = str(tmp_path / "state.npz")
    ht.save_state(ckpt, state)
    ranges, laser, _ = ht.load_log(os.path.join(
        os.path.dirname(__file__), "fixtures", "corridor_utm30lx.npz"))
    scan_log = str(tmp_path / "log.npz")
    ht.save_log(scan_log, ranges[:12], laser=laser)
    for src in (["--checkpoint", ckpt], ["--log", scan_log]):
        card, cpu = str(tmp_path / "card"), str(tmp_path / "cpu")
        assert main([*src, "--out", card]) == 0
        assert main([*src, "--out", cpu, "--device", "cpu"]) == 0
        for ext in (".png", ".tfw"):
            with open(card + ext, "rb") as a, open(cpu + ext, "rb") as b:
                assert a.read() == b.read(), (src, ext)


# ---- the sharded steps compiled: NCCL all-reduces inside CUDA graphs -----


def _rank_jobs():
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)   # the ranks import tools/ by name
    import tools.torch_sharded_ranks as jobs
    return jobs


@pytest.mark.cuda
def test_sharded_steps_compiled_on_one_nccl_rank_on_card(cuda_device,
                                                         tmp_path):
    """One NCCL rank (a (1, 1) mesh, its collectives identities, issued
    all the same): make_fleet_step, make_shared_fleet_step and
    shard_hypotheses capture their graphs once, with the all-reduces
    inside, and replay them with no capture and no stream sync, bit-equal
    to the bodies run eagerly in the turns between and to the unsharded
    compiled steps; one paint launch a step, and one in the warm-up."""
    jobs = _rank_jobs()
    from hector_slam_tpu_torch.parallel.sharded import run_ranks
    cfg, r, steps = ht.BENCH_CONFIG, 8, 4
    fleet_in = jobs._job_inputs(cfg, jobs.corridor_fleet(steps, r)[0])
    ref = np.load(jobs.SHARED_REFERENCE)
    shared_in = dict(jobs._job_inputs(cfg, ref["ranges"][:steps, :r]),
                     start_poses=ref["start_poses"][:r])
    state = ht.init_state(cfg, device=cuda_device)
    state, _ = ht.slam_step(state, ht.scan_from_numpy(
        fleet_in["points"][0, 0], fleet_in["origo"][0, 0],
        fleet_in["mask"][0, 0], device=cuda_device), cfg)
    hyp_in = dict(levels=[lo.cpu().numpy() for lo in state.log_odds],
                  hypotheses=np.random.default_rng(0).normal(
                      0, 0.05, (256, 3)).astype(np.float32),
                  **{k: v[1, 0] for k, v in fleet_in.items()})
    routes = ("step", "eager", "step")
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("f", "s", "h")}
    run_ranks(jobs.run_jobs, 1, "nccl", ([
        (jobs.fleet_job, (cfg, "cuda", 1, fleet_in, paths["f"], routes)),
        (jobs.shared_fleet_job, (cfg, "cuda", 1, shared_in, paths["s"],
                                 routes)),
        (jobs.hypotheses_job, (cfg, "cuda", 1, hyp_in, paths["h"],
                               ("step", "eager")))],), deadline_s=300.0)
    fleet, shared, hyp = (dict(np.load(p)) for p in paths.values())
    # the unsharded compiled steps in this process
    f = ht.init_fleet(cfg, r, device=cuda_device)
    s = ht.init_shared_fleet(cfg, r, start_poses=shared_in["start_poses"],
                             device=cuda_device)
    for t in range(steps):
        f, _ = ht.fleet_step_jit(f, ht.scan_from_numpy(
            fleet_in["points"][t], fleet_in["origo"][t], fleet_in["mask"][t],
            device=cuda_device), cfg)
        s, _ = ht.shared_fleet_step_jit(s, ht.scan_from_numpy(
            shared_in["points"][t], shared_in["origo"][t],
            shared_in["mask"][t], device=cuda_device), cfg)
    for got, want in ((fleet, f), (shared, s)):
        for i in range(3):
            t = jobs.turn(got, i)
            for k in ("poses", "gates", "truncated", "num_valid", "count",
                      "lo_0", "lo_1", "lo_2"):
                np.testing.assert_array_equal(t[k], jobs.turn(got, 1)[k],
                                              err_msg=k)
            assert t["captures"] == (1 if i == 0 else 0)
            assert t["syncs"] == 0 or routes[i] == "eager"
        np.testing.assert_array_equal(got["poses"][-1],
                                      want.pose.cpu().numpy())
        for k, lo in enumerate(want.log_odds):
            np.testing.assert_array_equal(got[f"lo_{k}"], lo.cpu().numpy())
        assert int(got["launches_raster_paint"]) == steps + 1
        assert int(got["t2_launches_raster_paint"]) == steps
        assert int(got["pool_bytes"]) > 0
    assert int(hyp["captures"]) == 1 and int(hyp["later_captures"]) == 0
    assert int(hyp["syncs"]) == 0
    np.testing.assert_array_equal(hyp["poses"], hyp["t1_poses"])
    np.testing.assert_array_equal(hyp["hessians"], hyp["t1_hessians"])


@pytest.mark.cuda
def test_sharded_steps_compiled_on_four_cards(cuda_device):
    """With four cards (skipped below): the 64-robot per-robot fleet on a
    (robot 4, beam 1) and a (2, 2) mesh, the 64-robot shared fleet over
    four ranks and shard_hypotheses at B = 4096 on BENCH_CONFIG, all
    through the compiled steps, one NCCL rank a card, held to the
    unsharded runs (tools/torch_sharded_ranks.py four_cards)."""
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four cards, {torch.cuda.device_count()} here")
    result = _rank_jobs().four_cards()
    assert result["ok"], result["checks"]
