"""Package boundaries of the PyTorch port: no module of
hector_slam_tpu_torch/, nor any script or test that runs on the card
(chip_smoke.py, tools/ablate_torch_kernels.py,
tools/torch_sharded_ranks.py, tests/test_torch_cuda.py,
tests/test_torch_tracing.py), imports JAX or the JAX package, and the
entry points put their tensors on the card unless the caller asks for
the CPU — raising, never falling back, when no card is present."""

import ast
import os

import numpy as np
import pytest
import torch

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch import probes
from hector_slam_tpu_torch.core.grid import init_log_odds_pyramid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "hector_slam_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "hector_slam_tpu")


def _port_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    # what runs on the card's machine, which has no JAX
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "ablate_torch_kernels.py")
    yield os.path.join(REPO, "tools", "torch_sharded_ranks.py")
    yield os.path.join(REPO, "tests", "test_torch_cuda.py")
    yield os.path.join(REPO, "tests", "test_torch_tracing.py")


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = list(_port_files())
    assert len(files) > 15
    # the modules of the last slice are among them
    for mod in ("core/covariance.py", "core/debug.py", "core/collectives.py",
                "query/raycast.py", "export/markers.py", "io/checkpoint.py",
                "io/attitude.py", "parallel/sharded.py", "core/graphs.py",
                "save_geotiff.py", "parallel/onehot_match.py",
                "parallel/pallas_match.py"):
        assert os.path.join(PKG, mod) in files, mod
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in FORBIDDEN, f"{path} imports {mod}"


# the JAX names the port does not have: none since the patch matcher, the
# Pallas-route names and the device-side occupancy grid were ported
NOT_PORTED = set()


def test_jax_only_names_are_the_documented_not_ported_list():
    """Every name of the JAX package's ``__all__`` is in the port's, the
    compiled entry points included. The compiled recoveries, like JAX's,
    live on their modules only."""
    import hector_slam_tpu as hs
    from hector_slam_tpu.core import covariance as jcov
    from hector_slam_tpu_torch.core import covariance
    from hector_slam_tpu_torch.parallel import batch, recovery, sharded
    assert set(hs.__all__) - set(ht.__all__) == NOT_PORTED
    assert set(hs.__all__) <= set(ht.__all__)
    for name in ("match_hypotheses_mxu_jit", "match_hypotheses_pallas_jit",
                 "to_occupancy_grid_jax"):
        assert callable(getattr(ht, name)), name
    assert ht.to_occupancy_grid_jax is ht.to_occupancy_grid_tensor
    for name in ("slam_step_jit", "run_log_jit", "match_hypotheses_jit",
                 "fleet_step_jit", "shared_fleet_step_jit",
                 "match_hypotheses_kernel_jit", "match_pyramid_debug_jit"):
        assert callable(getattr(ht, name)), name
    assert callable(recovery.cascade_refine_jit)
    assert callable(batch.residual_for_poses_jit)
    assert "cascade_refine_jit" not in hs.__all__
    assert "residual_for_poses_jit" not in hs.__all__
    # the covariance's compiled name lives on its module, as JAX's does
    assert callable(covariance.sigma_point_covariance_jit)
    assert callable(jcov.sigma_point_covariance_jit)
    assert "sigma_point_covariance_jit" not in hs.__all__ + ht.__all__
    for name in ("make_fleet_step", "make_shared_fleet_step",
                 "shard_hypotheses"):
        assert callable(getattr(sharded, name)), name
    assert all(hasattr(ht, name) for name in ht.__all__)
    # the port's own front end of a fleet: no JAX name, in the port's list
    assert "FleetSession" in ht.__all__ and "FleetSession" not in hs.__all__


def test_every_kernel_source_has_a_counted_wrapper():
    """Each csrc/<name>.cu has a wrapper ops/<name>.py:<wrapper> (named
    <name>, or as below) carrying the integer launch count chip_smoke.py
    reads, and a plain version <wrapper>_plain."""
    import importlib
    from hector_slam_tpu_torch.ops import cuda_build
    names = cuda_build.sources()
    assert set(names) == {"interp_moments", "paint_cells", "take_along",
                          "matmul_stationary", "dyn_slice", "paint_runs",
                          "map_tail", "robot_match", "raster_paint"}
    wrappers = {"robot_match": "robot_match_level"}
    for name in names:
        mod = importlib.import_module(f"hector_slam_tpu_torch.ops.{name}")
        wrapper = wrappers.get(name, name)
        assert isinstance(getattr(mod, wrapper).launches, int)
        assert callable(getattr(mod, f"{wrapper}_plain"))


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")


def test_entry_points_default_to_the_card_and_raise_without_one(no_card,
                                                               tmp_path):
    cfg = ht.SlamConfig(map=ht.MapConfig(size_x=64, size_y=64, levels=2))
    with pytest.raises(RuntimeError, match="cuda"):
        ht.init_state(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.scan_from_ranges(np.ones(1081, np.float32), 20.0)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.state_from_numpy([np.zeros((64, 64)), np.zeros((32, 32))],
                            np.zeros(3), np.zeros(3), np.zeros((3, 3)), 0,
                            0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.scan_from_numpy(np.zeros((8, 2)), np.zeros(2), np.ones(8, bool))
    with pytest.raises(RuntimeError, match="cuda"):
        ht.init_fleet(cfg, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.init_shared_fleet(cfg, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.FleetSession(cfg, robots=3)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.fleet_state_from_numpy(
            [np.zeros((3, 64, 64)), np.zeros((3, 32, 32))], np.zeros((3, 3)),
            np.zeros((3, 3)), np.zeros((3, 3, 3)), np.zeros(3), np.zeros(3),
            cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_log_odds_pyramid(cfg.map)
    ckpt = str(tmp_path / "state.npz")
    ht.save_state(ckpt, ht.init_state(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        ht.load_state(ckpt, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.distance_to_obstacle_batch(np.zeros((8, 8), np.int8),
                                      np.zeros((1, 2), np.int32),
                                      np.ones((1, 2), np.int32))
    assert ht.load_state(ckpt, cfg, device="cpu").pose.device.type == "cpu"
    from hector_slam_tpu_torch import save_geotiff
    geo = ["--checkpoint", ckpt, "--out", str(tmp_path / "geo"), "--size",
           "64", "--levels", "2"]
    with pytest.raises(RuntimeError, match="cuda"):
        save_geotiff.main(geo)
    assert not os.path.exists(str(tmp_path / "geo.png"))
    with pytest.raises(RuntimeError, match="cuda"):
        probes.workloads("mm")
    with pytest.raises(RuntimeError, match="cuda"):
        probes.main(["gather"])
    # the probes time the card: workloads built on the CPU are refused
    with pytest.raises(RuntimeError, match="cuda"):
        probes.run(probes.workloads("ds", device="cpu"))
    assert init_log_odds_pyramid(cfg.map, device="cpu")[1].shape == (32, 32)
    state = ht.init_state(cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in state.log_odds + state.quads)
    fleet = ht.init_fleet(cfg, 3, device="cpu")
    assert fleet.log_odds[1].shape == (3, 32, 32)
    assert fleet.quads[0].shape == (3, 64 * 64, 4)
    assert all(t.is_contiguous() for t in fleet.log_odds + fleet.quads)
    shared = ht.init_shared_fleet(cfg, 3, device="cpu")
    assert shared.log_odds[0].shape == (64, 64) and shared.pose.shape == (3, 3)
