"""The SLAM step's matcher level as one launch a level (ops/robot_match.py:
a block a robot, each robot on its own scan and its own map, or all on
one shared map).

On the CPU the wrapper runs its plain version, held bit for bit to the
torch loop ``core/matcher.match_level`` ran before the kernel (``gn_step``
per GN step) for a single pose, a fleet of per-robot maps and a fleet on
one shared map; ``match_level`` routes a single pose and a scan a pose to
the wrapper, and hypotheses sharing one scan, a beam-sharded scan and a
traced match to the torch loop; the wrapper refuses what the kernel does
not take. The ``cuda`` tests hold the kernel on the card to its plain
version at the tutorial launch's widths (one robot on both levels, 8
robots on 8 maps and on one shared map, an empty scan, a scan partly off
the map, a failed guard), robot r of a fleet bit for bit to its solo
launch, repeated launches bit for bit, and count the kernel's launches
in the step graphs. This file imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_robot_match.py
"""

import pytest
import torch

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import collectives, matcher
from hector_slam_tpu_torch.core.grid import world_to_map_pose
from hector_slam_tpu_torch.core.interp import hessian_derivs_quad
from hector_slam_tpu_torch.core.matcher import gn_step, level_points
from hector_slam_tpu_torch.core.slam import quads_of
from hector_slam_tpu_torch.io.simulator import (World, loop_trajectory,
                                                simulate_trajectory)
from hector_slam_tpu_torch.ops import robot_match as rm

EST_TOL = 1e-3     # cells (x, y) and rad: the hypothesis kernel's level bar
HESS_TOL = 1e-5    # relative to the largest |H| entry


def bits(t):
    return t.contiguous().view(torch.int32)


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


def _small_world(dev, robots=3, seed=4):
    """A small pyramid per robot (random log-odds, per-robot shifts), a
    ring of beams per robot with masked and off-map ones, and start
    estimates about the centre of each level."""
    gen = torch.Generator().manual_seed(seed)
    shapes = ((64, 72), (32, 36))
    base = [(torch.rand(hw, generator=gen) - 0.5) * 6.0 for hw in shapes]
    levels = tuple(torch.stack([torch.roll(b, 3 * r, dims=-1)
                                for r in range(robots)]).to(dev)
                   for b in base)
    n = 181
    ang = torch.linspace(-2.3, 2.3, n)
    rad = 4.0 + 30.0 * torch.rand((robots, n), generator=gen)
    points = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang)],
                         -1).to(dev)
    mask = (torch.rand((robots, n), generator=gen) > 0.15).to(dev)
    est = torch.stack([torch.full((robots,), 36.0), torch.full((robots,),
                                                              32.0),
                       0.1 * torch.arange(robots, dtype=torch.float32)],
                      -1)
    est = (est + 0.5 * torch.randn((robots, 3), generator=gen)
           * torch.tensor([2.0, 2.0, 0.05])).to(dev)
    return levels, quads_of(levels, "log_odds"), shapes, points, mask, est


def _torch_loop(quad, shape, est, points, mask, steps):
    """``match_level``'s GN loop before the kernel."""
    hess = None
    for _ in range(steps):
        est, hess = gn_step(quad, shape, est, points, mask)
    return est, hess


# ---- the CPU route --------------------------------------------------------


@pytest.mark.parametrize("layout", ["single", "per_robot", "shared"])
@pytest.mark.parametrize("level", [0, 1])
def test_cpu_route_bit_equal_to_the_torch_loop(layout, level):
    levels, quads, shapes, points, mask, est = _small_world("cpu")
    shape, steps = shapes[level], 4 + level
    pts = level_points(points, level)
    if layout == "single":
        args = (quads[level][0].contiguous(), shape, est[0], pts[0], mask[0])
        got = rm.robot_match_level(args[0], shape, est[:1], pts[:1],
                                   mask[:1], steps)
        got = (got[0][0], got[1][0])
    else:
        quad = (quads[level] if layout == "per_robot"
                else quads[level][1].contiguous())
        args = (quad, shape, est, pts, mask)
        got = rm.robot_match_level(*args, steps)
    want = _torch_loop(*args, steps)
    assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
    assert not torch.equal(got[0], args[2])   # the steps moved the pose


@pytest.mark.parametrize("layout", ["single", "per_robot", "shared"])
def test_match_level_cpu_bit_equal_to_the_torch_loop(layout):
    """``match_level`` through the wrapper against its old body: the torch
    loop, the angle normalised, the world frame, the empty-scan select."""
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=72,
                                         size_y=64, levels=2))
    mcfg = cfg.map
    levels, quads, shapes, points, mask, est = _small_world("cpu")
    mask[1] = False   # an empty scan
    level = 0
    world = matcher.map_to_world_pose(est, mcfg.top_left_offset,
                                      mcfg.level_resolution(level))
    if layout == "single":
        quad, world, points, mask = (quads[0][0].contiguous(), world[0],
                                     points[0], mask[0])
    else:
        quad = quads[0] if layout == "per_robot" else quads[0][2].contiguous()
    args = (quad, shapes[0], world, points, mask, 5, mcfg.top_left_offset,
            mcfg.level_scale(level), mcfg.level_resolution(level))
    got = matcher.match_level(*args)
    estimate = world_to_map_pose(world, args[6], args[7])
    estimate, hess = _torch_loop(quad, shapes[0], estimate, points, mask, 6)
    want_world = matcher.finish_level(estimate, args[6], args[8])
    any_valid = mask.any(-1)[..., None]
    want = (torch.where(any_valid, want_world, world),
            torch.where(any_valid[..., None], hess, torch.zeros_like(hess)))
    assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
    if layout != "single":
        assert torch.equal(got[0][1], world[1]) and not got[1][1].any()


class _Group:
    """A stand-in process group of ``size`` ranks."""

    def __init__(self, size):
        self.size = size


@pytest.fixture
def counted(monkeypatch):
    """Counts ``match_level``'s calls of the robot kernel's wrapper."""
    calls = []

    def wrapper(*args):
        calls.append(args[3].shape[0])
        return rm.robot_match_level(*args)

    monkeypatch.setattr(matcher, "robot_match_level", wrapper)
    monkeypatch.setattr(collectives.dist, "get_world_size",
                        lambda g: g.size)
    return calls


def test_match_level_routes_by_its_input(counted):
    """A single pose and a scan a pose (per-robot or shared maps) take the
    wrapper once a level; hypotheses sharing one scan and a traced match
    run the torch loop; a beam group of one rank reduces nothing and takes
    the wrapper, one of more ranks needs its all-reduce every GN step."""
    cfg = ht.SlamConfig(map=ht.MapConfig(resolution=0.05, size_x=72,
                                         size_y=64, levels=2))
    levels, quads, shapes, points, mask, est = _small_world("cpu")
    world = matcher.map_to_world_pose(est, cfg.map.top_left_offset,
                                      cfg.map.level_resolution(0))
    shared = tuple(lv[0] for lv in levels)
    one = ht.Scan(points[0], torch.zeros(2), mask[0])
    fleet = ht.Scan(points, torch.zeros((3, 2)), mask)
    matcher.match_pyramid(shared, world[0], one, cfg)
    assert counted == [1, 1]
    matcher.match_pyramid(levels, world, fleet, cfg, quads=quads)
    assert counted[2:] == [3, 3]
    matcher.match_pyramid(shared, world, fleet, cfg)
    assert counted[4:] == [3, 3]
    del counted[:]
    matcher.match_pyramid(shared, world, one, cfg)        # hypotheses
    trace = []
    matcher.match_pyramid(shared, world[0], one, cfg, trace=trace)
    assert counted == [] and len(trace) == 4 + 6
    assert matcher.robot_route(world, points, _Group(1), None)
    assert matcher.robot_route(world[0], points[0], None, None)
    assert not matcher.robot_route(world, points, _Group(2), None)
    assert not matcher.robot_route(world, points[0], None, None)
    assert not matcher.robot_route(world, points, None, [])


def _bad(case):
    levels, quads, shapes, points, mask, est = _small_world("cpu")
    args = dict(quads=quads[0], shape=shapes[0], estimates_map=est,
                points=points, mask=mask, steps=3)
    if case == "steps_zero":
        args["steps"] = 0
    elif case == "steps_fraction":
        args["steps"] = 2.5
    elif case == "steps_bool":
        args["steps"] = True
    elif case == "quads_dtype":
        args["quads"] = quads[0].double()
    elif case == "estimates_dtype":
        args["estimates_map"] = est.half()
    elif case == "points_dtype":
        args["points"] = points.double()
    elif case == "mask_dtype":
        args["mask"] = mask.to(torch.uint8)
    elif case == "quads_shape":
        args["quads"] = quads[0][:2]
    elif case == "estimates_shape":
        args["estimates_map"] = est[:, :2].contiguous()
    elif case == "shared_scan":
        args["points"] = points[0]
    elif case == "mask_shape":
        args["mask"] = mask[:, :-1].contiguous()
    elif case == "grid_shape":
        args["shape"] = (shapes[0][0], shapes[0][1] + 1)
    elif case == "tiny_grid":
        args["shape"] = (1, 8)
        args["quads"] = torch.zeros((3, 8, 4))
    elif case == "points_strides":
        args["points"] = points.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "too_many_beams":
        n = rm.MAX_POINTS + 1
        args["points"] = torch.zeros((3, n, 2))
        args["mask"] = torch.zeros((3, n), dtype=torch.bool)
    elif case == "device":
        args["mask"] = mask.to("meta")
    return args


REFUSED = {"steps_zero": ValueError, "steps_fraction": ValueError,
           "steps_bool": ValueError,
           "quads_dtype": TypeError, "estimates_dtype": TypeError,
           "points_dtype": TypeError, "mask_dtype": TypeError,
           "quads_shape": ValueError, "estimates_shape": ValueError,
           "shared_scan": ValueError, "mask_shape": ValueError,
           "grid_shape": ValueError, "tiny_grid": ValueError,
           "points_strides": ValueError, "too_many_beams": ValueError,
           "device": ValueError}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses_bad_inputs(case):
    with pytest.raises(REFUSED[case], match="robot_match_level"):
        rm.robot_match_level(**_bad(case))


# ---- on the card ----------------------------------------------------------


@pytest.fixture(scope="module")
def tutorial():
    """TUTORIAL_CONFIG's 2048^2, 2-level pyramid mapped on the card from
    the first 10 simulated UTM-30LX scans of the four-room loop at their
    true poses, 8 scans of the lap beyond them, and their true poses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    cfg = ht.TUTORIAL_CONFIG
    laser = ht.LaserModel()
    poses = loop_trajectory(754)[:18]
    ranges = simulate_trajectory(World.multi_room(), poses, laser,
                                 range_noise_std=0.01)
    scans = [ht.scan_from_ranges(r, cfg.map.level_scale(0), laser,
                                 cfg.max_beams, device=dev) for r in ranges]
    state = ht.init_state(cfg, device=dev)
    for sc, pose in zip(scans[:10], poses[:10]):
        state, _ = ht.slam_step(state, sc, cfg, pose_hint=torch.from_numpy(
            pose).to(dev), map_without_matching=True)
    return cfg, state, scans[10:], torch.from_numpy(poses[10:]).to(dev)


def _level_inputs(cfg, state, scans, poses, level, robots, maps):
    """The level's quads (``maps``: "one" the mapped grid, "per_robot" a
    copy a robot, robot r's moved r cells along x), shape, map-frame start
    estimates (the true poses moved 2 cm and 0.01 rad, and with the map),
    points and masks of ``robots`` scans."""
    shape = tuple(state.log_odds[level].shape)
    quad = state.quads[level]
    if maps == "per_robot":
        quad = torch.stack([torch.roll(quad.reshape(shape + (4,)), r, dims=1)
                            .reshape(-1, 4) for r in range(robots)])
    start = poses[:robots] + torch.tensor([0.02, -0.02, 0.01],
                                          device=poses.device)
    est = world_to_map_pose(start, cfg.map.top_left_offset,
                            cfg.map.level_scale(level)).contiguous()
    if maps == "per_robot":   # each robot where its map moved
        est[:, 0] += torch.arange(robots, device=est.device)
    points = torch.stack([level_points(s.points, level)
                          for s in scans[:robots]]).contiguous()
    mask = torch.stack([s.mask for s in scans[:robots]]).contiguous()
    steps = (cfg.match.iterations_finest if level == 0
             else cfg.match.iterations_coarse) + 1
    return quad.contiguous(), shape, est, points, mask, steps


def _hold_to_plain(quad, shape, est, points, mask, steps):
    """The kernel's estimates within EST_TOL of its plain version's, and
    its H within HESS_TOL (of the largest entry) of the plain moments at
    the kernel's own last step's start (a launch of steps - 1). Returns
    the kernel's result."""
    launches = rm.robot_match_level.launches
    got = rm.robot_match_level(quad, shape, est, points, mask, steps)
    torch.cuda.synchronize()
    assert rm.robot_match_level.launches == launches + 1
    want = rm.robot_match_level_plain(quad, shape, est, points, mask, steps)
    assert float((got[0] - want[0]).abs().max()) <= EST_TOL
    start = est if steps == 1 else rm.robot_match_level(
        quad, shape, est, points, mask, steps - 1)[0]
    hess, _ = hessian_derivs_quad(quad, shape, start, points, mask)
    scale = hess.abs().amax((-2, -1), keepdim=True).clamp(min=1e-30)
    assert float(((got[1] - hess).abs() / scale).max()) <= HESS_TOL
    assert bool(torch.isfinite(got[0]).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1])
def test_one_robot_matches_plain_on_card(tutorial, level):
    cfg, state, scans, poses = tutorial
    args = _level_inputs(cfg, state, scans, poses, level, 1, "one")
    got = _hold_to_plain(*args)
    assert not torch.equal(got[0], args[2])
    again = rm.robot_match_level(*args)
    assert same_bits(again[0], got[0]) and same_bits(again[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("maps", ["per_robot", "one"])
@pytest.mark.parametrize("level", [0, 1])
def test_fleet_matches_plain_and_solo_launches_on_card(tutorial, level,
                                                       maps):
    """8 robots on 8 maps or on one shared map: within the bars of the
    plain version, and robot r bit-equal to its solo launch on its own
    map."""
    cfg, state, scans, poses = tutorial
    quad, shape, est, points, mask, steps = _level_inputs(
        cfg, state, scans, poses, level, 8, maps)
    got = _hold_to_plain(quad, shape, est, points, mask, steps)
    for r in range(8):
        solo_quad = quad[r].contiguous() if maps == "per_robot" else quad
        solo = rm.robot_match_level(solo_quad, shape, est[r:r + 1],
                                    points[r:r + 1], mask[r:r + 1], steps)
        assert same_bits(solo[0][0], got[0][r])
        assert same_bits(solo[1][0], got[1][r])


@pytest.mark.cuda
def test_empty_off_map_and_unmapped_robots_on_card(tutorial):
    """Robot 0 with an empty scan keeps its estimate and sums H = 0; robot
    1 with every other beam moved past the map's edge (those fail the
    bounds test, the rest match); robot 2 on an unmapped patch (H = 0,
    the guard fails: the estimate stays); the others as they are. Each
    within the bars of the plain version."""
    cfg, state, scans, poses = tutorial
    quad, shape, est, points, mask, steps = _level_inputs(
        cfg, state, scans, poses, 0, 8, "one")
    mask[0] = False
    points[1, ::2] += float(shape[1])
    est[2, :2] = shape[0] - 40.0
    got = _hold_to_plain(quad, shape, est, points, mask, steps)
    assert torch.equal(got[0][0], est[0]) and not got[1][0].any()
    assert torch.equal(got[0][2], est[2]) and not got[1][2].any()
    assert bool(got[1][1].any())


@pytest.mark.cuda
def test_match_pyramid_kernel_route_near_torch_route_on_card(tutorial):
    """match_pyramid of one pose on the card (the kernel, once a level)
    within EST_TOL of its torch route (a traced match) in map cells."""
    cfg, state, scans, poses = tutorial
    start = poses[0] + torch.tensor([0.03, 0.02, -0.02], device=poses.device)
    launches = rm.robot_match_level.launches
    got = ht.match_pyramid(state.log_odds, start, scans[0], cfg,
                           quads=state.quads)
    assert rm.robot_match_level.launches == launches + cfg.map.levels
    want = ht.match_pyramid(state.log_odds, start, scans[0], cfg,
                            quads=state.quads, trace=[])
    assert rm.robot_match_level.launches == launches + cfg.map.levels
    gap = (got.pose - want.pose).abs()
    assert float(gap[:2].max()) <= EST_TOL * cfg.map.resolution
    assert float(gap[2]) <= EST_TOL


@pytest.mark.cuda
def test_step_graphs_launch_the_kernel_once_a_level_on_card(tutorial):
    """One replay of slam_step_jit and of fleet_step_jit at
    TUTORIAL_CONFIG: the robot kernel twice (once a level), the
    hypothesis kernel's forms never, one raster_paint launch (paint_cells
    none) and the map tail's two."""
    from hector_slam_tpu_torch.core import graphs
    cfg, _, scans, poses = tutorial
    dev = poses.device
    graphs.clear()
    state = ht.init_state(cfg, device=dev)
    for sc in scans[:3]:
        state, _ = ht.slam_step_jit(state, sc, cfg)
    fleet = ht.init_fleet(cfg, 2, device=dev)
    stacked = ht.stack_scans(scans[:2])
    for _ in range(3):
        fleet, _ = ht.fleet_step_jit(fleet, stacked, cfg)
    want = {"interp_moments": 0, "interp_moments_level": 0,
            "robot_match_level": cfg.map.levels, "paint_cells": 0,
            "raster_paint": 1, "map_tail": 2}
    stats = {s.name: s for s in graphs.stats()}
    for name in ("slam_step_jit", "fleet_step_jit"):
        assert stats[name].per_replay == want
        assert stats[name].warmup == want
    graphs.clear()
