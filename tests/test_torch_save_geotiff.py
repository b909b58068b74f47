"""The port's run-once geotiff saver (``python -m
hector_slam_tpu_torch.save_geotiff``) against the JAX package's
``tools/save_geotiff.py``, on the CPU (``--device cpu``): a JAX checkpoint
renders to .png and .tfw files byte-equal to the JAX tool's, and a log
replayed through ``--log`` renders byte-equal to the port's own
``run_log`` state drawn with its trajectory. Mirrors
``tests/test_ecosystem.py::test_save_geotiff_cli``."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hector_slam_tpu.config import MapConfig as JMapConfig
from hector_slam_tpu.config import SlamConfig as JSlamConfig
from hector_slam_tpu.core.slam import init_state as j_init_state
from hector_slam_tpu.core.slam import slam_step_jit as j_slam_step_jit
from hector_slam_tpu.io.checkpoint import save_state as j_save_state
from hector_slam_tpu.io.scanlog import LaserModel as JLaserModel
from hector_slam_tpu.io.scanlog import scan_from_ranges as j_scan
from hector_slam_tpu.io.simulator import (World, corridor_trajectory,
                                          simulate_trajectory)
from tools.save_geotiff import main as jax_main

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.save_geotiff import main

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "corridor_utm30lx.npz")
# tests/test_ecosystem.py's mapped room
MAP_KW = dict(resolution=0.05, size_x=256, size_y=256, levels=2)
LASER = JLaserModel(num_beams=271, angle_min=-2.356194490192345,
                    angle_increment=4 * 0.004363323129985824,
                    range_min=0.1, range_max=12.0)
LOG_SCANS = 40


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _size_flags(map_kw):
    return ["--resolution", str(map_kw["resolution"]),
            "--size", str(map_kw["size_x"]), "--levels", str(map_kw["levels"])]


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """tests/test_ecosystem.py's ``mapped_state``: a room mapped with
    known poses by the JAX package, saved as a JAX checkpoint."""
    cfg = JSlamConfig(map=JMapConfig(**MAP_KW), max_beams=384,
                      max_ray_cells=256)
    poses = corridor_trajectory(10, advance=0.06, weave=0.03)
    state = j_init_state(cfg)
    for r, p in zip(simulate_trajectory(World.room(size=10.0), poses,
                                        LASER), poses):
        state, _ = j_slam_step_jit(
            state, j_scan(r, cfg.map.level_scale(0), LASER, cfg.max_beams),
            cfg, pose_hint=jnp.asarray(p), map_without_matching=True)
    path = str(tmp_path_factory.mktemp("ckpt") / "state.npz")
    j_save_state(path, state)
    return path


@pytest.mark.parametrize("extra", [[], ["--no-coords", "--no-grid"]])
def test_checkpoint_renders_what_the_jax_tool_renders(tmp_path,
                                                      jax_checkpoint, extra):
    out, jout = str(tmp_path / "geo"), str(tmp_path / "jax_geo")
    flags = _size_flags(MAP_KW) + extra
    assert main(["--checkpoint", jax_checkpoint, "--out", out,
                 "--device", "cpu", *flags]) == 0
    assert jax_main(["--checkpoint", jax_checkpoint, "--out", jout,
                     *flags]) == 0
    for ext in (".png", ".tfw"):
        assert _read(out + ext) == _read(jout + ext), ext
    assert len(_read(out + ".png")) > 1000


def test_log_replay_renders_the_ports_run_log_state(tmp_path):
    """``--log`` on the fixture's first 40 scans at its own 1024^2 x 3
    levels: the files equal those rendered from the port's ``run_log``
    state and poses of the same scans."""
    ranges, laser, _ = ht.load_log(FIXTURE)
    log = str(tmp_path / "log.npz")
    ht.save_log(log, ranges[:LOG_SCANS], laser=laser)
    out, ref = str(tmp_path / "geo"), str(tmp_path / "ref")
    map_kw = dict(resolution=0.05, size_x=1024, size_y=1024, levels=3)
    assert main(["--log", log, "--out", out, "--device", "cpu",
                 *_size_flags(map_kw)]) == 0
    cfg = ht.SlamConfig(map=ht.MapConfig(**map_kw))
    scans = ht.stack_scans([
        ht.scan_from_ranges(r, 1.0 / cfg.map.resolution, laser,
                            cfg.max_beams, device="cpu")
        for r in ranges[:LOG_SCANS]])
    state, poses, metrics = ht.run_log(ht.init_state(cfg, device="cpu"),
                                       scans, cfg)
    assert int(metrics.map_updated.sum()) > 1
    ht.write_geotiff(ht.to_occupancy_grid(state.log_odds[0]),
                     ht.grid_meta(cfg.map), ref,
                     path_world=poses.numpy()[:, :2])
    for ext in (".png", ".tfw"):
        assert _read(out + ext) == _read(ref + ext), ext


def test_the_sources_are_exclusive_and_required(tmp_path):
    with pytest.raises(SystemExit):
        main(["--out", str(tmp_path / "geo"), "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--checkpoint", "a.npz", "--log", "b.npz",
              "--out", str(tmp_path / "geo"), "--device", "cpu"])
    assert not np.any([f.startswith("geo") for f in os.listdir(tmp_path)])
