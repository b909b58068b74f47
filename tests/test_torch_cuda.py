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

import numpy as np
import pytest
import torch

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core.interp import quad_pack
from hector_slam_tpu_torch.io.simulator import World, simulate_trajectory
from hector_slam_tpu_torch.ops import interp_moments as im
from hector_slam_tpu_torch.ops import dyn_slice as dsl
from hector_slam_tpu_torch.ops import matmul_stationary as mms
from hector_slam_tpu_torch.ops import paint_cells as pc
from hector_slam_tpu_torch.ops import paint_runs as pr
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
    matched through the kernel (one launch per GN step) and through the
    plain batched matcher agree."""
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
    got, diag = ht.match_hypotheses_kernel(state.log_odds, hyp, scans[-1],
                                           cfg, quads=state.quads)
    steps = (cfg.match.iterations_finest + 1) + (
        cfg.match.iterations_coarse + 1)
    assert im.interp_moments.launches == before + steps
    want = ht.match_pyramid(state.log_odds, hyp, scans[-1], cfg,
                            quads=state.quads)
    diff = (got.pose - want.pose).abs().max(-1).values.cpu().numpy()
    assert np.isfinite(got.pose.cpu().numpy()).all()
    assert np.percentile(diff, 90) < 2e-3
    assert float(diag.slow_queries) == 0.0


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
    (one batched step, one paint per set and level) and each alone
    through slam_step: poses, gates and maps bit-equal."""
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
    before = pc.paint_cells.launches
    for t in range(steps):
        fleet, m = ht.fleet_step(fleet, ht.stack_scans(
            [scan(rg) for rg in ranges[t]]), cfg)
        for i in range(r):
            solo[i], sm = ht.slam_step(solo[i], scan(ranges[t, i]), cfg)
            assert bool(sm.map_updated) == bool(m.map_updated[i])
    assert pc.paint_cells.launches > before
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
