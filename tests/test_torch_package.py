"""Package boundaries of the PyTorch port: no module of
hector_slam_tpu_torch/, nor any script or test that runs on the card
(chip_smoke.py, tools/profile_torch_port.py, tests/test_torch_cuda.py),
imports JAX or the JAX package, and the entry points put their tensors on the card unless the
caller asks for the CPU — raising, never falling back, when no card is
present."""

import ast
import os

import numpy as np
import pytest
import torch

import hector_slam_tpu_torch as ht

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
    yield os.path.join(REPO, "tools", "profile_torch_port.py")
    yield os.path.join(REPO, "tests", "test_torch_cuda.py")


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
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in FORBIDDEN, f"{path} imports {mod}"


def test_every_kernel_source_has_a_counted_wrapper():
    """Each csrc/<name>.cu has a wrapper ops/<name>.py:<name> carrying the
    integer launch count chip_smoke.py reads, and a plain version."""
    import importlib
    from hector_slam_tpu_torch.ops import cuda_build
    names = cuda_build.sources()
    assert "interp_moments" in names
    for name in names:
        mod = importlib.import_module(f"hector_slam_tpu_torch.ops.{name}")
        assert isinstance(getattr(mod, name).launches, int)
        assert callable(getattr(mod, f"{name}_plain"))


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")


def test_entry_points_default_to_the_card_and_raise_without_one(no_card):
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
    state = ht.init_state(cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in state.log_odds + state.quads)
