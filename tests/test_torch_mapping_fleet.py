"""The port's map update for R scans at once, on the CPU, against the
single-scan update and against the JAX package:

  - ``rasterize_scan`` on R scans: robot r's sets (per-robot layout, its
    cells offset by r*H*W into one paint) equal the sets of its scan
    alone, and the shared layout gives their OR;
  - ``update_pyramid`` with ``gates``: a per-robot pyramid equals JAX's
    ``update_level`` run robot by robot (non-gated robots unchanged); a
    shared pyramid equals the JAX shared fleet's combined update (the OR
    of the gated robots' JAX sets, applied once); one update of any
    layout is one paint call;
  - ``beam_sum``, the fixed-order sum the matcher's moments go through:
    a row sums the same bits whatever batch it sits in."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hector_slam_tpu.config import MapConfig as JMapConfig
from hector_slam_tpu.config import SlamConfig as JSlamConfig
from hector_slam_tpu.config import UpdateConfig as JUpdateConfig
from hector_slam_tpu.core import cell_models as jcells
from hector_slam_tpu.core import grid as jgrid
from hector_slam_tpu.core import mapping as jmap

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import grid as tgrid
from hector_slam_tpu_torch.core import mapping as tmap
from hector_slam_tpu_torch.core.interp import beam_sum
from hector_slam_tpu_torch.core.matcher import level_points
from hector_slam_tpu_torch.ops.paint_cells import paint_cell_sets
from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                simulate_trajectory)

LASER = ht.LaserModel(num_beams=271, angle_min=-2.356,
                      angle_increment=4 * 0.004363, range_min=0.1,
                      range_max=12.0)
MAP_KW = dict(resolution=0.05, size_x=256, size_y=256, levels=2)
CFG = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_ray_cells=256)
SHAPE = (256, 256)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corridor():
    poses = corridor_trajectory(4, advance=0.06, weave=0.03)
    ranges = simulate_trajectory(World.corridor(length=8.0, width=3.0),
                                 poses, LASER)
    scans = [ht.scan_from_ranges(r, CFG.map.level_scale(0), LASER,
                                 CFG.max_beams, device="cpu")
             for r in ranges]
    return poses, scans


def _args(pose, sc, k_cap):
    return (SHAPE, torch.from_numpy(pose), sc.points, sc.origo, sc.mask,
            CFG.map.top_left_offset, CFG.map.level_scale(0), k_cap)


@pytest.mark.parametrize("k_cap", [256, 40])
def test_rasterize_fleet_equals_single_scans(corridor, k_cap):
    """Per-robot: robot r's sets equal rasterize_scan of its scan alone
    (its cells offset by r*H*W into one paint); shared: the OR; a robot
    with an all-False mask contributes nothing."""
    poses, scans = corridor
    r = len(scans)
    stacked = ht.stack_scans(scans)
    mask = stacked.mask.clone()
    mask[2] = False
    p = torch.from_numpy(np.asarray(poses))
    args = (SHAPE, p, stacked.points, stacked.origo, mask,
            CFG.map.top_left_offset, CFG.map.level_scale(0), k_cap)
    free, occ, trunc = tmap.rasterize_scan(*args, per_robot=True)
    sfree, socc, strunc = tmap.rasterize_scan(*args)
    assert free.shape == (r,) + SHAPE and sfree.shape == SHAPE
    for i in range(r):
        sc = ht.Scan(stacked.points[i], stacked.origo[i], mask[i])
        one = tmap.rasterize_scan(*_args(poses[i], sc, k_cap))
        assert torch.equal(free[i], one[0]) and torch.equal(occ[i], one[1])
        assert int(trunc[i]) == int(one[2])
    assert not free[2].any() and not occ[2].any() and int(trunc[2]) == 0
    assert torch.equal(sfree, free.any(0)) and torch.equal(socc, occ.any(0))
    assert torch.equal(strunc, trunc)


def test_per_robot_indices_are_offset_single_indices(corridor):
    """Robot r's per-robot indices are its lone scan's indices plus
    r*H*W, sentinels moved to R*H*W; the shared layout keeps them."""
    poses, scans = corridor
    r, n = len(scans), SHAPE[0] * SHAPE[1]
    stacked = ht.stack_scans(scans)
    args = (SHAPE, torch.from_numpy(np.asarray(poses)), stacked.points,
            stacked.origo, stacked.mask, CFG.map.top_left_offset,
            CFG.map.level_scale(0), 256)
    free, occ, num, _ = tmap.cell_indices(*args, per_robot=True)
    sfree, socc, snum, _ = tmap.cell_indices(*args)
    assert (num, snum) == (r * n, n)
    for i in range(r):
        one_free, one_occ, one_num, _ = tmap.cell_indices(
            *_args(poses[i], scans[i], 256))
        assert one_num == n
        for got, shared, one in ((free[i], sfree[i], one_free),
                                 (occ[i], socc[i], one_occ)):
            assert torch.equal(shared, one)
            assert torch.equal(got, torch.where(one < n, one + i * n,
                                                r * n))


def _jax_pair(model):
    kw = dict(map=JMapConfig(**MAP_KW), max_ray_cells=256,
              update=JUpdateConfig(cell_model=model))
    jc = JSlamConfig(**kw)
    tc = ht.SlamConfig(map=ht.MapConfig(**MAP_KW), max_ray_cells=256,
                       update=ht.UpdateConfig(cell_model=model))
    return jc, tc


@pytest.mark.parametrize("model", ["log_odds", "reflectance"])
@pytest.mark.parametrize("layout", ["per_robot", "shared"])
def test_update_pyramid_with_gates_matches_jax(corridor, model, layout):
    """Two fleet updates of four robots, robot 1 not gated in the first
    and robot 3 not in the second, held bit for bit to JAX: per robot,
    ``update_level`` on each gated robot's own map; shared, the OR of
    the gated robots' ``rasterize_scan`` sets applied once per level."""
    poses, scans = corridor
    jc, tc = _jax_pair(model)
    r = len(scans)
    stacked = ht.stack_scans(scans)
    tposes = torch.from_numpy(np.asarray(poses))
    jlevels = list(jgrid.init_log_odds_pyramid(jc.map, model))
    tlevels = tgrid.init_log_odds_pyramid(tc.map, model, device="cpu")
    if layout == "per_robot":
        jlevels = [[lo] * r for lo in jlevels]
        tlevels = tuple(lo.expand((r,) + lo.shape).contiguous()
                        for lo in tlevels)
    for gates in ([True, False, True, True], [True, True, True, False]):
        g = torch.tensor(gates)
        tlevels, trunc = tmap.update_pyramid(tlevels, tposes, stacked, tc, gates=g)
        assert trunc.shape == (r,)
        for lvl in range(len(jlevels)):
            factor = 1.0 / 2 ** lvl
            if layout == "per_robot":
                for i in np.flatnonzero(gates):
                    sc = scans[i]
                    jlevels[lvl][i] = jmap.update_level(
                        jlevels[lvl][i], jnp.asarray(poses[i]),
                        jnp.asarray(sc.points.numpy()) * factor,
                        jnp.asarray(sc.origo.numpy()) * factor,
                        jnp.asarray(sc.mask.numpy()),
                        jc.map.top_left_offset, jc.map.level_scale(lvl),
                        jc.level_max_ray_cells(lvl), jc.update.log_odds_free,
                        jc.update.log_odds_occupied, cell_model=model,
                        raster_backend="xla")[0]
                continue
            shape = jlevels[lvl].shape[-2:]
            free = jnp.zeros(shape, bool)
            occ = jnp.zeros(shape, bool)
            for i in np.flatnonzero(gates):
                sc = scans[i]
                f, o, _ = jmap.rasterize_scan(
                    shape, jnp.asarray(poses[i]),
                    jnp.asarray(sc.points.numpy()) * factor,
                    jnp.asarray(sc.origo.numpy()) * factor,
                    jnp.asarray(sc.mask.numpy()), jc.map.top_left_offset,
                    jc.map.level_scale(lvl), jc.level_max_ray_cells(lvl))
                free, occ = free | f, occ | o
            jlevels[lvl] = jcells.apply_update(
                jlevels[lvl], free & ~occ, occ, model,
                jc.update.log_odds_free, jc.update.log_odds_occupied)
    for lvl, lo in enumerate(tlevels):
        want = (np.stack([np.asarray(x) for x in jlevels[lvl]])
                if layout == "per_robot" else np.asarray(jlevels[lvl]))
        np.testing.assert_array_equal(lo.numpy(), want)
        assert (lo != lo.flatten()[0]).any()


@pytest.mark.parametrize("layout", ["single", "per_robot", "shared"])
def test_update_pyramid_paints_once_per_update(corridor, monkeypatch,
                                               layout):
    """Every layout's update paints all 2 x levels cell sets in one
    ``paint_cell_sets`` call (one zero fill and one kernel launch on the
    card), and ``update_level`` its two sets in one. What the updates
    compute is held to JAX by the parity tests."""
    poses, scans = corridor
    r = len(scans)
    calls = []

    def counted(flats, sizes):
        calls.append(len(flats))
        return paint_cell_sets(flats, sizes)

    monkeypatch.setattr(tmap, "paint_cell_sets", counted)
    levels = tgrid.init_log_odds_pyramid(CFG.map, device="cpu")
    if layout == "single":
        pose, scan, gates = torch.from_numpy(poses[1]), scans[1], None
    else:
        pose, scan = torch.from_numpy(np.asarray(poses)), \
            ht.stack_scans(scans)
        gates = torch.tensor([True, False, True, True])
        if layout == "per_robot":
            levels = tuple(lo.expand((r,) + lo.shape).contiguous()
                           for lo in levels)
    for step in range(2):
        new, _ = tmap.update_pyramid(levels, pose, scan, CFG, gates=gates)
        assert calls == [2 * CFG.map.levels] * (step + 1)
        assert all((a != b).any() for a, b in zip(new, levels))
        levels = new
    mask = scan.mask if gates is None else scan.mask & gates[:, None]
    tmap.update_level(levels[1], pose, level_points(scan.points, 1),
                      level_points(scan.origo, 1), mask,
                      CFG.map.top_left_offset, CFG.map.level_scale(1),
                      CFG.level_max_ray_cells(1), CFG.update.log_odds_free,
                      CFG.update.log_odds_occupied)
    assert calls == [2 * CFG.map.levels] * 2 + [2]


@pytest.mark.parametrize("n", [1, 2, 9, 181, 1152])
def test_beam_sum_is_batch_independent(n):
    """A row's fixed-order sum is the same bits alone and inside a batch
    of 64 rows, over any beam count (odd counts fold their last column),
    and close to the exact sum."""
    rng = np.random.default_rng(n)
    rows = torch.from_numpy(rng.normal(0, 1, (64, n)).astype(np.float32))
    batch = beam_sum(rows)
    assert batch.shape == (64,)
    for i in (0, 17, 63):
        assert torch.equal(beam_sum(rows[i]), batch[i])
        exact = math.fsum(rows[i].double().tolist())
        assert abs(float(batch[i]) - exact) <= 1e-5 * max(1.0, n ** 0.5)
    assert torch.equal(beam_sum(rows[:, None, :].expand(64, 3, n))[:, 1],
                       batch)
