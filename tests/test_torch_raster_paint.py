"""The map update's rasterization and paint in one launch
(ops/raster_paint.py: every beam's Bresenham cells stored straight into
the painted grids, every level and every scan in one launch).

On the CPU the wrapper runs its plain version, the torch route of the
dense index sets painted by ``paint_cell_sets_plain``; it is held to the
route the map update takes on the CPU (``rasterize_scan``,
``rasterize_scan_seg`` and ``paint_pyramid``, in both free-set layouts):
grids and truncated counts equal for a live40-like scan, a fleet of 8
per-robot maps with mixed gates, a shared map of 8 robots, a beam shard,
and scans with truncated beams, beams leaving the map, beams ending in
their start cell and an all-masked robot. The wrapper refuses what the
kernel does not take. The ``cuda`` tests hold the kernel on the card to
its plain version bit for bit at live40's and fleet40's widths, and
count one launch a step in the step graphs. This file imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_raster_paint.py
"""

import numpy as np
import pytest
import torch

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import mapping as tmap
from hector_slam_tpu_torch.core.grid import init_log_odds_pyramid
from hector_slam_tpu_torch.core.matcher import level_points
from hector_slam_tpu_torch.io.simulator import (World, loop_trajectory,
                                                simulate_trajectory)
from hector_slam_tpu_torch.ops import paint_cells as pc
from hector_slam_tpu_torch.ops import raster_paint as rp

LASER = ht.LaserModel()
# live40's node settings on a quarter of its map width (the CPU tests)
SMALL = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=512,
                                       size_y=512, levels=2),
                      max_ray_cells=640)
# a short cap: most beams of the synthetic scans are truncated
SHORT = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=128,
                                       size_y=96, levels=3),
                      max_ray_cells=24)


def _levels(cfg):
    """``paint_pyramid``'s raster geometry of ``cfg``'s pyramid."""
    mcfg = cfg.map
    return [rp.RasterLevel(mcfg.level_size(lv)[::-1], 1.0 / (2.0 ** lv),
                           mcfg.top_left_offset, mcfg.level_scale(lv),
                           cfg.level_max_ray_cells(lv))
            for lv in range(mcfg.levels)]


def _loop_scans(cfg, robots, device="cpu", first=10):
    """``robots`` simulated UTM-30LX scans of the four-room loop, a few
    scans apart, and their true poses: (poses f32[R, 3], Scan [R, ...])."""
    poses = loop_trajectory(754)[first:first + 7 * robots:7]
    ranges = simulate_trajectory(World.multi_room(), poses, LASER,
                                 range_noise_std=0.01)
    scans = [ht.scan_from_ranges(r, cfg.map.level_scale(0), LASER,
                                 cfg.max_beams, device=device)
             for r in ranges]
    return (torch.from_numpy(np.asarray(poses, np.float32)).to(device),
            ht.stack_scans(scans))


def _edge_scans(cfg, robots=4, n=301, seed=5, device="cpu"):
    """Synthetic scans in ``cfg``'s map-scaled units: beams up to well
    past the map's edge, every 17th ending in its start cell, 10% masked,
    robot 1 all masked and robot 2 standing outside the map."""
    rng = np.random.default_rng(seed)
    h, w = cfg.map.size_y, cfg.map.size_x
    ang = np.linspace(-2.4, 2.4, n)
    rad = rng.uniform(0.0, 1.3 * max(h, w), (robots, n))
    rad[:, ::17] = 0.2
    points = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    mask = rng.random((robots, n)) > 0.1
    mask[1] = False
    res = cfg.map.resolution
    poses = np.c_[rng.uniform(-0.3, 0.3, (robots, 2)) * np.array([w, h])
                  * res, rng.uniform(-3.0, 3.0, robots)]
    poses[2, :2] = (0.7 * w * res, 0.0)
    origo = rng.uniform(-1.0, 1.0, (robots, 2))
    return (torch.tensor(poses, dtype=torch.float32, device=device),
            ht.Scan(torch.tensor(points, dtype=torch.float32, device=device),
                    torch.tensor(origo, dtype=torch.float32, device=device),
                    torch.tensor(mask, device=device)))


def _pyramid(cfg, robots, device="cpu"):
    levels = init_log_odds_pyramid(cfg.map, device=device)
    if robots:
        levels = tuple(lo.expand((robots,) + lo.shape).contiguous()
                       for lo in levels)
    return levels


def _equal(got, want):
    """Two ``RasterSets`` equal: grids, per-level and total counts."""
    for (gf, go), (wf, wo) in zip(got.sets, want.sets):
        assert gf.dtype == wf.dtype == torch.bool
        assert gf.shape == wf.shape and torch.equal(gf, wf)
        assert go.shape == wo.shape and torch.equal(go, wo)
    assert torch.equal(got.level_truncated, want.level_truncated)
    assert got.truncated.dtype == want.truncated.dtype == torch.int32
    assert torch.equal(got.truncated, want.truncated)


# ---- the plain version against the CPU route ------------------------------


def _against_the_cpu_route(cfg, poses, scan, layout, backends):
    """``raster_paint`` (CPU: its plain version) against each level's
    ``rasterize_scan`` (and ``rasterize_scan_seg`` for one scan) and
    against ``paint_pyramid`` in each of ``backends``."""
    per_robot = layout == "per_robot"
    levels = _levels(cfg)
    got = rp.raster_paint(levels, poses, scan.points, scan.origo, scan.mask,
                          per_robot)
    _equal(got, rp.raster_paint_plain(levels, poses, scan.points,
                                      scan.origo, scan.mask, per_robot))
    assert any(f.any() for f, _ in got.sets)
    for k, lv in enumerate(levels):
        args = (lv.shape, poses, level_points(scan.points, k),
                level_points(scan.origo, k), scan.mask, lv.offset, lv.scale,
                lv.max_ray_cells)
        routes = [tmap.rasterize_scan(*args, per_robot=per_robot)]
        if layout == "single":
            routes.append(tmap.rasterize_scan_seg(*args))
        for free, occ, trunc in routes:
            assert torch.equal(got.sets[k][0], free)
            assert torch.equal(got.sets[k][1], occ)
            assert torch.equal(got.level_truncated[k], trunc)
    pyramid = _pyramid(cfg, scan.mask.shape[0] if per_robot else 0)
    for backend in backends:
        sets, truncated = tmap.paint_pyramid(pyramid, poses, scan, cfg,
                                             raster_backend=backend)
        for (f, o), (wf, wo) in zip(got.sets, sets):
            assert torch.equal(f, wf) and torch.equal(o, wo)
        assert torch.equal(got.truncated, truncated)
    return got


@pytest.mark.parametrize("backend", ["seg", "xla"])
def test_live40_like_scan_equals_the_cpu_route(backend):
    """One UTM-30LX scan of the four-room loop on live40's 2048^2 x 2
    pyramid, both free-set layouts."""
    cfg = ht.TUTORIAL_CONFIG
    poses, scans = _loop_scans(cfg, 1)
    scan = ht.Scan(scans.points[0], scans.origo[0], scans.mask[0])
    got = _against_the_cpu_route(cfg, poses[0], scan, "single", [backend])
    assert got.truncated.shape == () and int(got.truncated) == 0


def test_fleet_of_8_with_mixed_gates_equals_the_cpu_route():
    """8 robots on 8 maps, robots 1, 4 and 6 not gated: their cells and
    truncations are masked out, as ``paint_pyramid`` masks them."""
    poses, scan = _loop_scans(SMALL, 8)
    gates = torch.tensor([True, False, True, True, False, True, False, True])
    masked = ht.Scan(scan.points, scan.origo, scan.mask & gates[:, None])
    got = _against_the_cpu_route(SMALL, poses, masked, "per_robot", [None])
    sets, _ = tmap.paint_pyramid(_pyramid(SMALL, 8), poses, scan, SMALL,
                                 gates=gates)
    for (f, o), (wf, wo) in zip(got.sets, sets):
        assert torch.equal(f, wf) and torch.equal(o, wo)
        assert f.shape == (8,) + f.shape[1:]
        assert not f[~gates].any() and f[gates].flatten(1).any(1).all()


def test_shared_map_of_8_equals_the_cpu_route():
    """8 robots into one map: the OR of their cells, a count a robot."""
    poses, scan = _loop_scans(SMALL, 8)
    got = _against_the_cpu_route(SMALL, poses, scan, "shared", [None])
    assert got.truncated.shape == (8,)
    ones = [rp.raster_paint_plain(_levels(SMALL), poses[r], scan.points[r],
                                  scan.origo[r], scan.mask[r])
            for r in range(8)]
    for k, (free, occ) in enumerate(got.sets):
        assert torch.equal(free, torch.stack([o.sets[k][0] for o in ones])
                           .any(0))
        assert torch.equal(occ, torch.stack([o.sets[k][1] for o in ones])
                           .any(0))


@pytest.mark.parametrize("layout", ["per_robot", "shared"])
def test_beam_shard_equals_the_cpu_route(layout):
    """A rank's block of beams (the second of four, a strided slice of
    the fleet's scan) paints what the CPU route paints from it."""
    poses, scan = _loop_scans(SMALL, 8)
    n = scan.points.shape[1] // 4
    shard = ht.Scan(scan.points[:, n:2 * n], scan.origo,
                    scan.mask[:, n:2 * n])
    assert not shard.points.is_contiguous()
    _against_the_cpu_route(SMALL, poses, shard, layout, [None])


@pytest.mark.parametrize("layout", ["single", "per_robot", "shared"])
def test_edge_cases_equal_the_cpu_route(layout):
    """Truncated beams (abs_da > K on every level), beams leaving the map,
    beams ending in their start cell, an all-masked robot and a robot
    outside the map."""
    poses, scan = _edge_scans(SHORT)
    if layout == "single":
        poses, scan = poses[0], ht.Scan(scan.points[0], scan.origo[0],
                                        scan.mask[0])
        backends = ["seg", "xla"]
    else:
        backends = [None]
    got = _against_the_cpu_route(SHORT, poses, scan, layout, backends)
    assert (got.level_truncated > 0).all(-1).all() if layout == "single" \
        else (got.level_truncated[:, 0] > 0).all()
    if layout != "single":
        # the all-masked robot and the one outside the map paint nothing
        assert (got.level_truncated[:, 1:3] == 0).all()
        if layout == "per_robot":
            assert not any(f[1:3].any() or o[1:3].any()
                           for f, o in got.sets)


def test_update_level_takes_the_level_points_as_given():
    """``update_level``'s points are the level's own (point_scale 1): its
    sets equal ``rasterize_scan``'s at the level."""
    poses, scan = _edge_scans(SHORT)
    lv = _levels(SHORT)[1]
    storage = init_log_odds_pyramid(SHORT.map, device="cpu")[1]
    pts, org = level_points(scan.points[0], 1), level_points(scan.origo[0], 1)
    new, trunc = tmap.update_level(
        storage, poses[0], pts, org, scan.mask[0], lv.offset, lv.scale,
        lv.max_ray_cells, 0.4, 0.9)
    got = rp.raster_paint([lv._replace(point_scale=1.0)], poses[0], pts, org,
                          scan.mask[0])
    assert torch.equal(trunc, got.truncated) and int(trunc) > 0
    free, occ = got.sets[0]
    assert torch.equal(new != storage, free | occ)


def test_cpu_route_launches_nothing():
    poses, scan = _edge_scans(SHORT)
    before = (rp.raster_paint.launches, pc.paint_cells.launches)
    rp.raster_paint(_levels(SHORT), poses, scan.points, scan.origo,
                    scan.mask, True)
    assert (rp.raster_paint.launches, pc.paint_cells.launches) == before


def test_no_beams_paints_nothing():
    poses, scan = _edge_scans(SHORT)
    got = rp.raster_paint(_levels(SHORT), poses, scan.points[:, :0],
                          scan.origo, scan.mask[:, :0], True)
    assert not any(f.any() or o.any() for f, o in got.sets)
    assert not got.truncated.any()


# ---- refused inputs --------------------------------------------------------


def _refused_cases():
    poses, scan = _edge_scans(SHORT)
    levels = _levels(SHORT)
    ok = dict(levels=levels, pose_world=poses, points=scan.points,
              origo=scan.origo, mask=scan.mask, per_robot=True)
    big = rp.RasterLevel((46341, 46341), 1.0, (0.0, 0.0), 20.0, 8)
    return [
        ("no levels", dict(levels=[]), ValueError),
        ("9 levels", dict(levels=levels * 3), ValueError),
        ("pose rank", dict(pose_world=poses[None]), ValueError),
        ("pose dtype", dict(pose_world=poses.double()), TypeError),
        ("points dtype", dict(points=scan.points.half()), TypeError),
        ("origo shape", dict(origo=scan.origo[:, :1]), ValueError),
        ("mask dtype", dict(mask=scan.mask.int()), TypeError),
        ("mask beams", dict(mask=scan.mask[:, 1:]), ValueError),
        ("points robots", dict(points=scan.points[1:]), ValueError),
        ("per robot of one pose", dict(pose_world=poses[0],
                                       points=scan.points[0],
                                       origo=scan.origo[0],
                                       mask=scan.mask[0]), ValueError),
        ("empty grid", dict(levels=[levels[0]._replace(shape=(0, 4))]),
         ValueError),
        ("no ray cells", dict(levels=[levels[0]._replace(max_ray_cells=0)]),
         ValueError),
        ("grids past 2^31 cells", dict(levels=[big]), ValueError),
        ("too many scans", dict(
            pose_world=torch.zeros(65536, 3), points=torch.zeros(65536, 1, 2),
            origo=torch.zeros(65536, 2),
            mask=torch.zeros(65536, 1, dtype=torch.bool), per_robot=False),
         ValueError),
    ], ok


REFUSED, OK = _refused_cases()


@pytest.mark.parametrize("case", REFUSED, ids=[c[0] for c in REFUSED])
def test_refused_inputs(case):
    _, change, error = case
    with pytest.raises(error, match="raster_paint"):
        rp.raster_paint(**{**OK, **change})


# ---- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(levels, poses, scan, per_robot):
    """One launch, bit-equal to the plain version on the same tensors, and
    a second launch bit-identical."""
    before = (rp.raster_paint.launches, pc.paint_cells.launches)
    got = rp.raster_paint(levels, poses, scan.points, scan.origo, scan.mask,
                          per_robot)
    again = rp.raster_paint(levels, poses, scan.points, scan.origo,
                            scan.mask, per_robot)
    torch.cuda.synchronize()
    assert (rp.raster_paint.launches, pc.paint_cells.launches) == (
        before[0] + 2, before[1])
    _equal(got, rp.raster_paint_plain(levels, poses, scan.points,
                                      scan.origo, scan.mask, per_robot))
    _equal(got, again)
    return got


@pytest.mark.cuda
def test_live40_inputs_on_card(cuda_device):
    cfg = ht.TUTORIAL_CONFIG
    poses, scans = _loop_scans(cfg, 1, cuda_device)
    got = _kernel_vs_plain(_levels(cfg), poses[0], ht.Scan(
        scans.points[0], scans.origo[0], scans.mask[0]), False)
    assert got.sets[0][0].any() and got.truncated.shape == ()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["per_robot", "shared"])
def test_fleet40_inputs_on_card(cuda_device, layout):
    """8 robots at live40's widths, robots 1, 4 and 6 masked out as
    ungated, on 8 maps or one."""
    cfg = ht.TUTORIAL_CONFIG
    poses, scan = _loop_scans(cfg, 8, cuda_device)
    gates = torch.tensor([True, False, True, True, False, True, False, True],
                         device=cuda_device)
    scan = ht.Scan(scan.points, scan.origo, scan.mask & gates[:, None])
    got = _kernel_vs_plain(_levels(cfg), poses, scan,
                           layout == "per_robot")
    assert got.truncated.shape == (8,)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["per_robot", "shared"])
def test_beam_shard_on_card(cuda_device, layout):
    cfg = ht.TUTORIAL_CONFIG
    poses, scan = _loop_scans(cfg, 8, cuda_device)
    n = scan.points.shape[1] // 4
    _kernel_vs_plain(_levels(cfg), poses, ht.Scan(
        scan.points[:, n:2 * n], scan.origo, scan.mask[:, n:2 * n]),
        layout == "per_robot")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["single", "per_robot", "shared"])
def test_edge_cases_on_card(cuda_device, layout):
    """Truncated beams on every level, beams leaving the map or ending in
    their start cell, an all-masked robot, a robot outside the map."""
    poses, scan = _edge_scans(SHORT, device=cuda_device)
    if layout == "single":
        poses, scan = poses[0], ht.Scan(scan.points[0], scan.origo[0],
                                        scan.mask[0])
    got = _kernel_vs_plain(_levels(SHORT), poses, scan,
                           layout == "per_robot")
    assert int(got.truncated.sum()) > 0


@pytest.mark.cuda
def test_step_graphs_paint_with_one_launch_on_card(cuda_device):
    """A replay of shared_fleet_step_jit paints with one raster_paint
    launch and no paint_cells launch (slam_step_jit and fleet_step_jit:
    tests/test_torch_robot_match.py), and its maps equal its eager
    body's."""
    from hector_slam_tpu_torch.core import graphs
    cfg = SMALL
    poses, scan = _loop_scans(cfg, 4, cuda_device)
    graphs.clear()
    shared = ht.init_shared_fleet(cfg, 4, start_poses=poses,
                                  device=cuda_device)
    eager = ht.init_shared_fleet(cfg, 4, start_poses=poses,
                                 device=cuda_device)
    for _ in range(3):
        shared, _ = ht.shared_fleet_step_jit(shared, scan, cfg)
        eager, _ = ht.shared_fleet_step(eager, scan, cfg)
    [entry] = graphs.stats()
    want = {"raster_paint": 1, "paint_cells": 0, "map_tail": 2}
    assert {k: entry.per_replay[k] for k in want} == want
    assert {k: entry.warmup[k] for k in want} == want
    for a, b in zip(shared.log_odds, eager.log_odds):
        assert torch.equal(a, b)
    graphs.clear()
