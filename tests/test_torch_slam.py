"""The port's sequential SLAM loop against the JAX engine on the committed
corridor fixture (tests/fixtures/corridor_utm30lx.npz, 435 scans of 1081
beams) at the full BENCH_CONFIG width (1024^2 @ 0.05 m, 3 levels, 1152
padded beams), on the CPU.

Budgets: the gate must agree on every scan and the map-update counts must
be equal (discrete decisions); pose RMSE against JAX < 5 mm, the
JAX-vs-reference budget of tests/test_real_log.py. Measured (CPU f32):
pose RMSE 7.1e-7 m over the 150-scan prefix (max 3.8e-6 m); the engines
differ by exp ulps and f32 summation order, which the GN iterations
amplify later in the log (chip_smoke.py replays all 435 scans)."""

import numpy as np
import pytest
import torch

from hector_slam_tpu.config import BENCH_CONFIG as JCFG
from hector_slam_tpu.core.slam import init_state as j_init, run_log_jit
from hector_slam_tpu.io.scanlog import (scan_from_ranges as j_scan,
                                        stack_scans as j_stack)

import hector_slam_tpu_torch as ht
from tools.make_torch_reference import FIXTURE, REFERENCE, jax_reference

PREFIX = 150
CARRY_AT, CARRY_LEN = 60, 20


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_replay():
    return jax_reference(FIXTURE)


@pytest.fixture(scope="module")
def port_scans():
    ranges, laser, _ = ht.load_log(FIXTURE)
    cfg = ht.BENCH_CONFIG
    return ht.stack_scans([ht.scan_from_ranges(
        r, cfg.map.level_scale(0), laser, cfg.max_beams, device="cpu")
        for r in ranges])


def _rmse(a, b):
    return float(np.sqrt(np.mean((a[:, :2] - b[:, :2]) ** 2)))


def test_reference_trajectory_is_current(jax_replay):
    """tools/make_torch_reference.py regenerates the committed reference
    that chip_smoke.py holds the card against."""
    with np.load(REFERENCE) as ref:
        np.testing.assert_array_equal(ref["poses"], jax_replay["poses"])
        np.testing.assert_array_equal(ref["map_updated"],
                                      jax_replay["map_updated"])
        assert int(ref["map_update_count"]) == \
            int(jax_replay["map_update_count"])
    assert jax_replay["poses"].shape == (435, 3)


def test_fixture_prefix_matches_jax(jax_replay, port_scans):
    cfg = ht.BENCH_CONFIG
    scans = ht.Scan(*(f[:PREFIX] for f in port_scans))
    state, poses, metrics = ht.run_log(ht.init_state(cfg, device="cpu"),
                                       scans, cfg)
    want = jax_replay["poses"][:PREFIX]
    gates = metrics.map_updated.numpy()
    np.testing.assert_array_equal(gates, jax_replay["map_updated"][:PREFIX])
    assert int(state.map_update_count) == int(gates.sum()) > 5
    assert int(metrics.truncated_free_cells.sum()) == 0
    assert (metrics.num_valid_beams.numpy() > 900).all()
    rmse = _rmse(poses.numpy(), want)
    assert rmse < 0.005, rmse
    assert state.step.item() == PREFIX


def test_state_carried_across_from_jax(jax_replay, port_scans):
    """A JAX state after CARRY_AT scans, handed over as numpy through
    state_from_numpy, continues in the port as it does in JAX."""
    ranges, laser, _ = ht.load_log(FIXTURE)
    jscans = j_stack([j_scan(r, JCFG.map.level_scale(0), laser,
                             JCFG.max_beams) for r in ranges[:CARRY_AT]])
    jstate, _, _ = run_log_jit(j_init(JCFG), jscans, JCFG)
    cfg = ht.BENCH_CONFIG
    state = ht.state_from_numpy(
        [np.asarray(lo) for lo in jstate.log_odds], np.asarray(jstate.pose),
        np.asarray(jstate.last_map_update_pose),
        np.asarray(jstate.covariance), int(jstate.step),
        int(jstate.map_update_count), cfg, device="cpu")
    for lvl, q in enumerate(state.quads):
        np.testing.assert_allclose(q.numpy(), np.asarray(jstate.quads[lvl]),
                                   rtol=3e-7, atol=0)   # exp: <= 2 ulp
    window = slice(CARRY_AT, CARRY_AT + CARRY_LEN)
    scans = ht.scan_from_numpy(port_scans.points[window].numpy(),
                               port_scans.origo[window].numpy(),
                               port_scans.mask[window].numpy(),
                               device="cpu")
    state, poses, metrics = ht.run_log(state, scans, cfg)
    np.testing.assert_array_equal(metrics.map_updated.numpy(),
                                  jax_replay["map_updated"][window])
    assert _rmse(poses.numpy(), jax_replay["poses"][window]) < 1e-4
    assert int(state.step) == CARRY_AT + CARRY_LEN
