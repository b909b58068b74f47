"""The probe kernels' plain versions against the Pallas TPU probes they
port, run on the CPU in interpret mode with seeded inputs:

  * ``ops/take_along.py`` vs ``tools/probe_pallas.py:gather_tiles`` and
    ``gather_big``;
  * ``ops/dyn_slice.py`` vs ``dyn_slice`` (its three modes);
  * ``ops/matmul_stationary.py`` vs ``matmul_stationary``;
  * ``ops/paint_runs.py`` vs ``tools/probe_mosaic_store.py:
    make_run_kernel``.

``tools/probe_pallas.py`` runs nothing at import; its module-level ``pl``
is swapped for a namespace whose ``pallas_call`` runs in interpret mode,
and its jitted ``f`` gets the seeded arrays directly (never the probes'
``args()``, which seed from the clock). ``tools/probe_mosaic_store.py``
runs both probes when it is imported, so ``make_run_kernel`` is taken
out of its source with ``ast``.

Tolerances: exact for all but the matmul. The matmul is held to MM_ULPS
bf16 ulp per element: XLA's and torch's f32 sums read 0 ulps apart at
m = 256 and reps 1, 8 and 64 on this CPU, and a sum taken in another
order can round to the neighbouring bf16 near a tie (the card's tensor
cores read 1 ulp, tests/test_torch_cuda.py)."""

import ast
import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hector_slam_tpu_torch.ops import dyn_slice as dsl
from hector_slam_tpu_torch.ops import matmul_stationary as mms
from hector_slam_tpu_torch.ops import paint_runs as pr
from hector_slam_tpu_torch.ops import take_along as ta
# shortcut-revealing inputs shared with the card tests (no JAX there)
from test_torch_cuda import TINY_TERM_CASES, sum_order_inputs, tiny_term_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
MM_ULPS = 1


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def probe_pallas():
    """tools/probe_pallas.py with its pallas_call in interpret mode."""
    path = os.path.join(TOOLS, "probe_pallas.py")
    spec = importlib.util.spec_from_file_location("_probe_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interp = types.ModuleType("pl")
    interp.__dict__.update(vars(pl))
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = interp
    return mod


def _np(x):
    return np.array(x)   # a writable copy for torch.from_numpy


@pytest.mark.parametrize("axis", [1, 0])
def test_take_along_equals_gather_tiles(probe_pallas, axis):
    """4 tiles of [8,128], 3 reps: every tile reads the first tile's
    accumulator."""
    rng = np.random.default_rng(60 + axis)
    p = rng.random((32, 128), dtype=np.float32)
    idx = rng.integers(0, (8, 128)[axis], (32, 128)).astype(np.int32)
    f, _ = probe_pallas.gather_tiles(axis, tiles=4)(3)
    want = _np(f(jnp.asarray(p), jnp.asarray(idx)))
    got = ta.take_along(torch.from_numpy(p), torch.from_numpy(idx), 3, axis,
                        tile_rows=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).all()


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("shape", [(32, 256), (32, 128), (8, 256), (8, 128)])
def test_take_along_equals_gather_big(probe_pallas, shape, axis):
    rng = np.random.default_rng(64)
    p = rng.random(shape, dtype=np.float32)
    idx = rng.integers(0, shape[axis], shape).astype(np.int32)
    f, _ = probe_pallas.gather_big(shape, axis)(3)
    want = _np(f(jnp.asarray(p), jnp.asarray(idx)))
    got = ta.take_along_plain(torch.from_numpy(p), torch.from_numpy(idx), 3,
                              axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_take_along_one_tile_is_gather_big():
    """gather_big is gather_tiles with one tile: tile_rows = rows."""
    rng = np.random.default_rng(65)
    p = torch.from_numpy(rng.random((16, 32), dtype=np.float32))
    idx = torch.from_numpy(rng.integers(0, 32, (16, 32)).astype(np.int32))
    assert torch.equal(ta.take_along(p, idx, 5, 1),
                       ta.take_along(p, idx, 5, 1, tile_rows=16))
    with pytest.raises(ValueError, match="does not divide"):
        ta.take_along_plain(p, idx, 1, 1, tile_rows=5)


def _take_along_without_the_term(p, idx, reps, axis, tile_rows):
    """take_along_plain with ``acc[0] * 1e-30`` dropped: the shortcut the
    tiny-term inputs must expose."""
    tiles, th, tw = ta._tiling(p, tile_rows)
    pt = p.reshape(tiles, th, tw)
    it = idx.reshape(tiles, th, tw)
    acc = torch.zeros_like(pt)
    for i in range(reps):
        ix = torch.remainder(it + i, (th, tw)[axis]).to(torch.int64)
        acc = acc + torch.take_along_dim(pt, ix, dim=axis + 1)
    return acc.reshape(p.shape)


@pytest.mark.parametrize("case,axis", TINY_TERM_CASES)
def test_take_along_tiny_term_changes_the_result(probe_pallas, case, axis):
    """Tiles 1-3 all 0, or one tile half 0: the plain version equals the
    probe (gather_tiles / gather_big in interpret mode) at 4 reps, and
    the same function without the 1e-30 term does not."""
    p, idx, tile_rows = tiny_term_inputs(case, axis)
    if tile_rows is None:
        f, _ = probe_pallas.gather_big(p.shape, axis)(4)
    else:
        f, _ = probe_pallas.gather_tiles(axis, tiles=4)(4)
    want = _np(f(jnp.asarray(p), jnp.asarray(idx)))
    tp, ti = torch.from_numpy(p), torch.from_numpy(idx)
    got = ta.take_along(tp, ti, 4, axis, tile_rows)
    np.testing.assert_array_equal(got.numpy(), want)
    short = _take_along_without_the_term(tp, ti, 4, axis, tile_rows)
    assert not torch.equal(short, got)


@pytest.mark.parametrize("shape,axis", [((4, 1024), 1), ((1024, 4), 0)])
def test_take_along_long_lines_equal_gather_big(probe_pallas, shape, axis):
    """Lines of 1024 positions (longer than a warp's 256, the card's block
    path) on each axis, 3 reps: the plain version equals the probe in
    interpret mode."""
    rng = np.random.default_rng(71 + axis)
    p = rng.random(shape, dtype=np.float32)
    idx = rng.integers(0, shape[axis], shape).astype(np.int32)
    f, _ = probe_pallas.gather_big(shape, axis)(3)
    want = _np(f(jnp.asarray(p), jnp.asarray(idx)))
    got = ta.take_along_plain(torch.from_numpy(p), torch.from_numpy(idx), 3,
                              axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_take_along_refuses_lines_longer_than_a_warp_holds():
    """A line of the gathered axis is held on one SM of the card (a warp
    up to 256 positions, a block's shared memory up to MAX_LINE): the
    wrapper takes lines up to MAX_LINE and refuses a longer one on the CPU
    tensor as on the card, before any work; the number of lines is
    free."""
    assert ta.MAX_LINE == 8192
    for shape, axis, tile_rows in (((2, 8192), 1, None),
                                   ((2 * 8192, 2), 0, 8192)):
        p = torch.ones(shape)
        idx = torch.zeros(shape, dtype=torch.int32)
        assert torch.equal(ta.take_along(p, idx, 1, axis, tile_rows),
                           torch.ones(shape))
    for shape, axis in (((2, 8193), 1), ((8193, 2), 0)):
        p = torch.zeros(shape)
        idx = torch.zeros(shape, dtype=torch.int32)
        with pytest.raises(ValueError, match="at most 8192"):
            ta.take_along(p, idx, 1, axis)
    idx = torch.zeros(4, 8193, dtype=torch.int32)
    assert ta._check(torch.zeros(4, 8193), idx, 1, 0, 2) == (2, 2, 8193)
    assert ta._check(torch.zeros(8192, 256), torch.zeros(
        8192, 256, dtype=torch.int32), 1, 1, None) == (1, 8192, 256)


@pytest.mark.parametrize("mode", dsl.MODES)
def test_dyn_slice_sum_order_changes_the_result(probe_pallas, mode):
    """A grid of 2**24 and 1.0 values: the plain version equals the probe
    in interpret mode (40 reps, adds in loop order), and a pairwise sum of
    the same patches does not."""
    g, ys, xs = sum_order_inputs(mode)
    f, _ = probe_pallas.dyn_slice(grid_hw=g.shape, mode=mode)(40)
    want = _np(f(jnp.asarray(g), jnp.asarray(ys), jnp.asarray(xs)))
    tg, tys, txs = (torch.from_numpy(v) for v in (g, ys, xs))
    got = dsl.dyn_slice(tg, tys, txs, 40, (32, 128), mode)
    np.testing.assert_array_equal(got.numpy(), want)
    y0, x0 = dsl.resolve_offsets(tys, txs, tuple(g.shape), (32, 128), mode)
    parts = [tg[y:y + 32, x:x + 128] for y, x in zip(y0[:40].tolist(),
                                                      x0[:40].tolist())]
    while len(parts) > 1:
        parts = [parts[k] + parts[k + 1] if k + 1 < len(parts) else parts[k]
                 for k in range(0, len(parts), 2)]
    assert not torch.equal(parts[0], got)


@pytest.mark.parametrize("mode", dsl.MODES)
def test_dyn_slice_equals_probe(probe_pallas, mode):
    """256^2, 600 reps: the 512-slot table wraps."""
    rng = np.random.default_rng(66)
    g = rng.random((256, 256), dtype=np.float32)
    ys = rng.integers(0, 256 - 32, 512).astype(np.int32)
    xs = rng.integers(0, 256 - 128, 512).astype(np.int32)
    f, _ = probe_pallas.dyn_slice(grid_hw=(256, 256), mode=mode)(600)
    want = _np(f(jnp.asarray(g), jnp.asarray(ys), jnp.asarray(xs)))
    got = dsl.dyn_slice(torch.from_numpy(g), torch.from_numpy(ys),
                        torch.from_numpy(xs), 600, (32, 128), mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", dsl.MODES)
def test_dyn_slice_offsets_outside_the_grid(probe_pallas, mode):
    """Starts beyond the edge and negative resolve as the probe's loads
    resolve them: a negative start wrapped once by the dimension, then
    clamped to [0, dim - patch] (on 256^2 with a [32,128] patch: y=250 ->
    224, x=200 -> 128, y=-5 -> 224, y=-300 -> 0)."""
    pairs = np.array([(250, 200), (-5, -5), (-300, -300), (1000, 1000),
                      (-256, -129), (-257, -1), (10, 127), (-1, -130)],
                     np.int32)
    ys, xs = np.resize(pairs[:, 0], 512), np.resize(pairs[:, 1], 512)
    g = np.arange(256 * 256, dtype=np.float32).reshape(256, 256)
    y0, x0 = dsl.resolve_offsets(torch.from_numpy(ys), torch.from_numpy(xs),
                                 (256, 256), (32, 128), mode)
    assert y0[:4].tolist() == [224, 224, 0, 224]
    want_x = {"y": [0, 0, 0, 0], "xal": [128, 128, 0, 128],
              "both": [128, 128, 0, 128]}[mode]
    assert x0[:4].tolist() == want_x
    f, _ = probe_pallas.dyn_slice(grid_hw=(256, 256), mode=mode)(len(pairs))
    want = _np(f(jnp.asarray(g), jnp.asarray(ys), jnp.asarray(xs)))
    got = dsl.dyn_slice_plain(torch.from_numpy(g), torch.from_numpy(ys),
                              torch.from_numpy(xs), len(pairs), (32, 128),
                              mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reps", [1, 8, 64])
def test_matmul_stationary_equals_probe(probe_pallas, reps):
    """m = 256, the probe's operand scales (a ~ U(0, 0.1), w ~ U(0,
    0.01)): within MM_ULPS bf16 ulps of the probe."""
    rng = np.random.default_rng(67)
    a = jnp.asarray(rng.random((256, 128)) * 0.1, jnp.bfloat16)
    w = jnp.asarray(rng.random((128, 128)) * 0.01, jnp.bfloat16)
    f, _ = probe_pallas.matmul_stationary(256, 128, 128)(reps)
    want = torch.from_numpy(_np(f(a, w)))
    got = mms.matmul_stationary(
        torch.from_numpy(_np(a.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(_np(w.astype(jnp.float32))).to(torch.bfloat16),
        reps)
    assert got.dtype == torch.float32 and got.shape == (256, 128)
    assert float(want.abs().min()) > 0
    assert float(mms.bf16_ulps(got, want).max()) <= MM_ULPS


def test_bf16_ulps_counts_neighbours():
    """One bf16 step at 1, 3 and -0.75 (2^-7, 2^-6, 2^-8) is one ulp."""
    x = torch.tensor([1.0, 3.0, -0.75])
    step = torch.tensor([2 ** -7, 2 ** -6, 2 ** -8])
    assert mms.bf16_ulps(x + step, x).tolist() == [1.0, 1.0, 1.0]
    assert mms.bf16_ulps(x - step / 2, x).tolist() == [0.5, 0.5, 0.5]
    assert float(mms.bf16_ulps(x, x).max()) == 0.0


def _probe_run_kernel(h, w):
    """``make_run_kernel`` from the probe's source, with the module's grid
    size H = W bound to (h, w)."""
    path = os.path.join(TOOLS, "probe_mosaic_store.py")
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "make_run_kernel")
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "H": h, "W": w}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["make_run_kernel"]


def test_paint_runs_equals_the_probe_kernel():
    """64 x 256, 500 runs drawn as the probe draws them."""
    h, w, n = 64, 256, 500
    rng = np.random.default_rng(68)
    lo = rng.integers(0, 120, n)
    runs = [rng.integers(0, h, n), rng.integers(0, w // 128, n) * 128, lo,
            np.minimum(lo + rng.integers(0, 8, n), 127)]
    runs = [r.astype(np.int32) for r in runs]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4, grid=(1,), in_specs=[],
        out_specs=pl.BlockSpec((h, w), lambda i, *_: (0, 0),
                               memory_space=pltpu.VMEM))
    f = pl.pallas_call(_probe_run_kernel(h, w)(n), grid_spec=grid_spec,
                       out_shape=jax.ShapeDtypeStruct((h, w), jnp.float32),
                       interpret=True)
    want = _np(f(*(jnp.asarray(r) for r in runs)))
    got = pr.paint_runs(*(torch.from_numpy(r) for r in runs), (h, w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 500 < int(got.sum()) < 500 * 8


@pytest.mark.parametrize("field,value", [
    (1, 64), (1, 256), (1, -128), (0, 64), (0, -1), (2, -1), (3, 128),
    (3, 2)])
def test_paint_runs_rejects_runs_off_the_segment(field, value):
    """The TPU kernel's precondition: c0 a multiple of 128 with the
    [1, 128] segment inside the 64 x 256 grid, 0 <= row < 64,
    0 <= lo <= hi < 128. Run 3 of four breaks it: the error names it and
    nothing is painted."""
    runs = [torch.tensor(v, dtype=torch.int32) for v in (
        [0, 1, 2, 3], [0, 128, 0, 128], [0, 5, 9, 4], [0, 7, 9, 6])]
    assert int(pr.paint_runs(*runs, (64, 256)).sum()) == 1 + 3 + 1 + 3
    runs[field][3] = value
    with pytest.raises(ValueError, match=r"run 3 \(row"):
        pr.paint_runs(*runs, (64, 256))
    with pytest.raises(TypeError):
        pr.paint_runs(*(r.long() for r in runs), (64, 256))


def test_cpu_paths_are_not_counted():
    """On CPU tensors every wrapper takes its plain version and counts
    no launch."""
    counts = [f.launches for f in (ta.take_along, dsl.dyn_slice,
                                   mms.matmul_stationary, pr.paint_runs)]
    p = torch.ones(8, 128)
    ta.take_along(p, torch.zeros(8, 128, dtype=torch.int32), 2, 1)
    dsl.dyn_slice(torch.ones(64, 256), torch.zeros(512, dtype=torch.int32),
                  torch.zeros(512, dtype=torch.int32), 3)
    mms.matmul_stationary(torch.ones(16, 128, dtype=torch.bfloat16),
                          torch.ones(128, 128, dtype=torch.bfloat16), 1)
    z = torch.zeros(1, dtype=torch.int32)
    pr.paint_runs(z, z, z, z, (1, 128))
    assert counts == [f.launches for f in (ta.take_along, dsl.dyn_slice,
                                           mms.matmul_stationary,
                                           pr.paint_runs)]
