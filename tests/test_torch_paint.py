"""The paint kernel's plain version (ops/paint_cells.py) against the JAX
package on the CPU, bit for bit:

  (a) the map update's scatter-OR ``_scatter_true``
      (hector_slam_tpu/core/mapping.py:155-160);
  (b) the TPU probe kernel it ports, ``make_store_kernel`` of
      tools/probe_mosaic_store.py, run through ``pallas_call`` with
      ``interpret=True`` at 64^2. That module runs both probes when it is
      imported, so the kernel's source is taken out of it with ``ast``.

And the contract the CUDA kernel shares (tests/test_torch_cuda.py holds
the kernel to this version on the card): indices outside [0, num_cells),
the map update's sentinel among them, are dropped; duplicates paint once;
the map update never produces a negative index."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hector_slam_tpu.core import mapping as jmap

import hector_slam_tpu_torch as ht
from hector_slam_tpu_torch.core import mapping as tmap
from hector_slam_tpu_torch.ops import paint_cells as pc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(REPO, "tools", "probe_mosaic_store.py")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "corridor_utm30lx.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _probe_store_kernel(h, w):
    """``make_store_kernel`` from the probe's source, with the module's
    grid size H = W bound to (h, w)."""
    tree = ast.parse(open(PROBE, encoding="utf-8").read(), PROBE)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "make_store_kernel")
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "H": h, "W": w}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), PROBE, "exec"), ns)
    return ns["make_store_kernel"]


def _run_probe(ys, xs, h, w):
    """The probe's pallas_call (tools/probe_mosaic_store.py:48-60) in
    interpret mode: f32[h, w], 1.0 at every (y, x)."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(1,), in_specs=[],
        out_specs=pl.BlockSpec((h, w), lambda i, *_: (0, 0),
                               memory_space=pltpu.VMEM))
    f = pl.pallas_call(_probe_store_kernel(h, w)(len(ys)),
                       grid_spec=grid_spec,
                       out_shape=jax.ShapeDtypeStruct((h, w), jnp.float32),
                       interpret=True)
    return np.asarray(f(jnp.asarray(ys, jnp.int32), jnp.asarray(xs,
                                                                jnp.int32)))


def test_plain_equals_the_probe_kernel():
    h = w = 64
    rng = np.random.default_rng(51)
    ys = rng.integers(0, h, 700).astype(np.int32)
    xs = rng.integers(0, w, 700).astype(np.int32)
    ys[-50:], xs[-50:] = ys[:50], xs[:50]          # duplicate stores
    want = _run_probe(ys, xs, h, w)
    got = pc.paint_cells_plain(torch.from_numpy(ys * w + xs), h * w)
    assert got.dtype == torch.bool and got.shape == (h * w,)
    np.testing.assert_array_equal(got.numpy().reshape(h, w), want == 1.0)
    assert 0 < int(got.sum()) < 700


@pytest.mark.parametrize("shape", [(64, 96), (1, 1), (128, 128)])
def test_plain_equals_jax_scatter_true(shape):
    """Random in-range indices mixed with the sentinel h*w, in the [N, K]
    layout of the dense free set."""
    h, w = shape
    n = h * w
    rng = np.random.default_rng(52)
    flat = rng.integers(0, n, (40, 33)).astype(np.int32)
    flat[rng.random(flat.shape) < 0.3] = n
    got = pc.paint_cells(torch.from_numpy(flat), n).reshape(h, w)
    want = jmap._scatter_true(jnp.asarray(flat), (h, w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_drops_out_of_range_and_keeps_duplicates_once():
    flat = torch.tensor([3, 3, 3, 0, 9, 10, 11, -1, -10, 2 ** 31 - 1],
                        dtype=torch.int32)
    got = pc.paint_cells(flat, 10)    # CPU tensor: the plain version
    want = np.zeros(10, bool)
    want[[0, 3, 9]] = True
    np.testing.assert_array_equal(got.numpy(), want)
    empty = pc.paint_cells(torch.zeros(0, dtype=torch.int32), 7)
    assert empty.shape == (7,) and not empty.any()


def test_cpu_path_is_not_counted():
    before = pc.paint_cells.launches
    pc.paint_cells(torch.arange(5, dtype=torch.int32), 8)
    assert pc.paint_cells.launches == before


def test_map_update_indices_are_never_negative():
    """The kernel drops negative indices where index_put_ and JAX wrap
    them; the map update never makes one. Every dense free/occupied index
    of the fixture's scans, at every level of BENCH_CONFIG, lies in
    [0, num_cells] (num_cells being the sentinel)."""
    cfg = ht.BENCH_CONFIG
    ranges, laser, poses = ht.load_log(FIXTURE)
    for t in range(0, len(ranges), 29):
        scan = ht.scan_from_ranges(ranges[t], cfg.map.level_scale(0), laser,
                                   cfg.max_beams, device="cpu")
        pose = torch.from_numpy(np.asarray(poses[t], np.float32))
        for level in range(cfg.map.levels):
            sx, sy = cfg.map.level_size(level)
            free, occ, n, _ = tmap.cell_indices(
                (sy, sx), pose, scan.points * (1.0 / 2 ** level),
                scan.origo * (1.0 / 2 ** level), scan.mask,
                cfg.map.top_left_offset, cfg.map.level_scale(level),
                cfg.level_max_ray_cells(level))
            assert n == sx * sy
            for idx in (free, occ):
                assert int(idx.min()) >= 0 and int(idx.max()) <= sx * sy
            assert int((free < sx * sy).sum()) > 1000


def _mixed_table(rng):
    """Eight sets on grids of several sizes: random in-range indices with
    duplicates and sentinels, an empty set, one index, an all-sentinel
    set, and a set of negative and too-large indices."""
    sizes = [64 * 96, 37, 4096, 1, 128 * 128, 300, 5, 64 * 64]
    flats = []
    for k, n in enumerate(sizes):
        f = rng.integers(0, n, 400 + 37 * k).astype(np.int32)
        f[rng.random(f.size) < 0.3] = n
        f[: f.size // 4] = f[f.size // 4: 2 * (f.size // 4)]
        flats.append(f)
    flats[1] = flats[1][:0]
    flats[3] = np.array([0], np.int32)
    flats[5] = np.full(77, 300, np.int32)
    flats[6] = np.array([-1, 4, -7, 5, 2 ** 31 - 1, 4, 0], np.int32)
    return flats, sizes


def test_plain_sets_equal_per_set_and_jax():
    """paint_cell_sets_plain (and paint_cell_sets on CPU tensors) is the
    per-set paint_cells_plain, and equals the JAX _scatter_true on every
    set without negative indices (JAX wraps those; the map update never
    makes one)."""
    flats, sizes = _mixed_table(np.random.default_rng(53))
    tflats = [torch.from_numpy(f) for f in flats]
    got = pc.paint_cell_sets_plain(tflats, sizes)
    assert [g.shape for g in got] == [(n,) for n in sizes]
    for g, f, n in zip(got, tflats, sizes):
        assert torch.equal(g, pc.paint_cells_plain(f, n))
    for g, w in zip(pc.paint_cell_sets(tflats, sizes), got):
        assert torch.equal(g, w)
    for g, f, n in zip(got, flats, sizes):
        if (f < 0).any():
            continue
        want = jmap._scatter_true(jnp.asarray(f), (1, n))
        np.testing.assert_array_equal(g.numpy(), np.asarray(want)[0])
    assert not got[1].any() and int(got[3].sum()) == 1
    assert not got[5].any()
    np.testing.assert_array_equal(np.flatnonzero(got[6].numpy()), [0, 4])


def test_sets_refuse_bad_tables_on_cpu():
    idx = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        pc.paint_cell_sets([idx, idx], [8])
    with pytest.raises(ValueError):
        pc.paint_cell_sets([], [])
    with pytest.raises(TypeError):
        pc.paint_cell_sets([idx, idx.long()], [8, 8])
    with pytest.raises(ValueError):
        pc.paint_cell_sets([idx], [0])
    with pytest.raises(ValueError):
        pc.paint_cell_sets([idx.reshape(2, 2).t()], [8])
