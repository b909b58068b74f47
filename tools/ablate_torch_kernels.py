"""Ablations of the port's two SLAM-path CUDA kernels on one card.

    python3 tools/ablate_torch_kernels.py

Builds variants of ``csrc/interp_moments.cu`` and ``csrc/paint_cells.cu``
(the committed source with one constant or statement replaced, each
compiled with the port's nvcc flags into ``hector_slam_tpu_torch/build/
ablate/``) and times every variant's bare launch on the main path's
inputs, as device time (``probes.time_ms``: calls queued behind a device
sleep):

  interp_moments, on the bench.py workload (a map from 10 simulated
  corridor scans, hypotheses sigma 0.05, levels 0 and 2) at B = 1024,
  2048, 4096 and 8192, and on chip_smoke.py's random 1024^2 inputs:
    kernel   the committed source
    unroll4  kUnroll = 4
    empty    staging and the reduction only (no query): launch + staging
    launch   no staging and no query: the launch floor
  paint_cells, one update's six cell sets of each map-update path
  (sequential scan, 64-robot fleet, 64-robot shared map), zero fill
  included:
    kernel       the committed source (read-first at >= 16 slots per cell)
    never_read   no set reads before it writes
    always_read  every set reads before it writes

One JSON line per workload; every variant is also held to the committed
kernel's result (moments within 1e-5 and used counts equal; grids
equal). Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12


def _sub(src, old, new):
    if old not in src:
        raise RuntimeError(f"ablation target not in the source: {old!r}")
    return src.replace(old, new)


def _variants():
    from hector_slam_tpu_torch.ops import cuda_build
    im = (cuda_build.CSRC / "interp_moments.cu").read_text()
    pc = (cuda_build.CSRC / "paint_cells.cu").read_text()
    empty = _sub(im, "  __syncthreads();\n\n  const int b =",
                 "  __syncthreads();\n  nv = 0;\n  const int b =")
    return {
        "interp_moments": {
            "kernel": im,
            "unroll4": _sub(im, "kUnroll = 2;", "kUnroll = 4;"),
            "empty": empty,
            "launch": _sub(empty, "  for (int base = 0, t = 0; base < n;",
                           "  for (int base = 0, t = 0; base < 0;"),
        },
        "paint_cells": {
            "kernel": pc,
            "never_read": _sub(pc, "kReadFirstSlotsPerCell = 16;",
                               "kReadFirstSlotsPerCell = 1LL << 32;"),
            "always_read": _sub(pc, "kReadFirstSlotsPerCell = 16;",
                                "kReadFirstSlotsPerCell = 0;"),
        },
    }


def _build(variants):
    """{kernel: {variant: ctypes library}}, one nvcc per variant, all
    started together; prints each variant's registers and spills."""
    from hector_slam_tpu_torch.ops import cuda_build
    out = cuda_build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, srcs in variants.items():
        for name, src in srcs.items():
            cu = out / f"{kernel}_{name}.cu"
            cu.write_text(src)
            so = out / f"{kernel}_{name}.so"
            procs[kernel, name] = (subprocess.Popen(
                [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for (kernel, name), (proc, so) in procs.items():
        text, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{text}")
        print(json.dumps({"build": f"{kernel} {name}", "ptxas": [
            ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
        libs.setdefault(kernel, {})[name] = ctypes.CDLL(str(so))
    return libs


def _moments_workloads():
    import hector_slam_tpu_torch as ht
    from hector_slam_tpu_torch.core.grid import world_to_map_pose
    from hector_slam_tpu_torch.core.interp import quad_pack
    from hector_slam_tpu_torch.core.matcher import level_points
    from hector_slam_tpu_torch.io.simulator import (World, corridor_trajectory,
                                                    simulate_trajectory)
    cfg = ht.BENCH_CONFIG
    laser = ht.LaserModel()
    truth = corridor_trajectory(10, advance=0.12, weave=0.03)
    ranges = simulate_trajectory(World.corridor(length=18.0, width=3.0),
                                 truth, laser, range_noise_std=0.005)
    scans = [ht.scan_from_ranges(r, cfg.map.level_scale(0), laser,
                                 cfg.max_beams) for r in ranges]
    state = ht.init_state(cfg)
    for sc, p in zip(scans, truth):
        state, _ = ht.slam_step(state, sc, cfg,
                                pose_hint=torch.from_numpy(p).cuda(),
                                map_without_matching=True)
    for b in (4096, 1024, 2048, 8192):
        hyp = torch.from_numpy((truth[-1] + np.random.default_rng(0).normal(
            0, 0.05, (b, 3))).astype(np.float32)).cuda()
        for lvl in ((0, 2) if b == 4096 else (0,)):
            yield (f"bench L{lvl} B={b}", state.quads[lvl],
                   tuple(state.log_odds[lvl].shape),
                   world_to_map_pose(hyp, cfg.map.top_left_offset,
                                     cfg.map.level_scale(lvl)).contiguous(),
                   level_points(scans[-1].points, lvl).contiguous(),
                   scans[-1].mask)
    rng = np.random.default_rng(1)   # chip_smoke.py's kernel-vs-plain inputs
    b, n, size = 4096, 1152, 1024
    quad = quad_pack(torch.from_numpy(
        rng.random((size, size), dtype=np.float32)).cuda())
    ang = np.linspace(-2.356, 2.356, n).astype(np.float32)
    rad = rng.uniform(0.02, 0.6, n).astype(np.float32) * size
    pts = torch.from_numpy(np.stack([rad * np.cos(ang), rad * np.sin(ang)],
                                    -1).astype(np.float32)).cuda()
    poses = torch.from_numpy(np.c_[size / 2 + rng.normal(0, 2.0, (b, 2)),
                                   rng.normal(0, 0.05, b)].astype(
                                       np.float32)).cuda()
    yield ("random 1024^2 B=4096", quad, (size, size), poses, pts,
           torch.from_numpy(np.arange(n) < 1081).cuda())


def _ablate_moments(libs):
    from hector_slam_tpu_torch.ops.interp_moments import prepare
    from hector_slam_tpu_torch.probes import time_ms
    for name, quad, shape, poses, pts, mask in _moments_workloads():
        sin_t, cos_t, _ = prepare(quad, shape, poses, pts, mask)
        row, want = {"interp_moments": name}, None
        for variant, lib in libs.items():
            fn = lib.hs_interp_moments
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, i, i, p, p, p, i, p, p, i, p, p]
            out = torch.empty((poses.shape[0], 10), device="cuda")

            def call():
                rc = fn(quad.data_ptr(), shape[0], shape[1], poses.data_ptr(),
                        sin_t.data_ptr(), cos_t.data_ptr(), poses.shape[0],
                        pts.data_ptr(), mask.data_ptr(), pts.shape[0],
                        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{variant}: CUDA error {rc}")

            row[f"{variant}_ms"] = time_ms(call, 50)[0]
            torch.cuda.synchronize()
            if variant in ("empty", "launch"):
                continue
            if want is None:
                want = out.clone()
                row["used"] = float(want[:, 9].sum())
                continue
            scale = want[:, :9].abs().max(-1).values.clamp(min=1e-30)
            row[f"{variant}_agrees"] = bool(
                torch.equal(out[:, 9], want[:, 9])
                and float(((out[:, :9] - want[:, :9]).abs().max(-1).values
                           / scale).max()) <= 1e-5)
        print(json.dumps(row), flush=True)


def _paint_workloads():
    import hector_slam_tpu_torch as ht
    import chip_smoke as cs
    cfg = ht.BENCH_CONFIG
    laser = ht.LaserModel()

    def scans_of(ranges):
        return ht.stack_scans([ht.scan_from_ranges(
            r, cfg.map.level_scale(0), laser, cfg.max_beams) for r in ranges])

    fx_ranges, fx_laser, _ = ht.load_log(os.path.join(
        REPO, "tests", "fixtures", "corridor_utm30lx.npz"))
    ref = np.load(os.path.join(REPO, "tests", "fixtures",
                               "corridor_jax_reference.npz"))
    t = int(np.flatnonzero(ref["map_updated"])[26])   # a mid-log update
    yield ("sequential", *cs.paint_index_sets(
        cfg, torch.from_numpy(ref["poses"][t].astype(np.float32)).cuda(),
        ht.scan_from_ranges(
            fx_ranges[t], cfg.map.level_scale(0), fx_laser, cfg.max_beams),
        "single"))
    fleet, _ = cs.fleet_ranges()
    yield ("fleet", *cs.paint_index_sets(   # step 0: every robot at its origin
        cfg, torch.zeros((cs.FLEET_ROBOTS, 3), device="cuda"),
        scans_of(fleet[0]), "per_robot"))
    shared = np.load(os.path.join(REPO, "tests", "fixtures",
                                  "shared_fleet_jax_reference.npz"))
    yield ("shared_fleet", *cs.paint_index_sets(
        cfg, torch.from_numpy(shared["start_poses"].astype(np.float32)).cuda(),
        scans_of(shared["ranges"][0]), "shared"))


def _ablate_paint(libs):
    from hector_slam_tpu_torch.ops.paint_cells import _offsets
    from hector_slam_tpu_torch.probes import time_ms
    for name, _, flats, sizes in _paint_workloads():
        offs = _offsets(sizes)
        buf = torch.empty(offs[-1], dtype=torch.bool, device="cuda")
        k = len(flats)
        args = ((ctypes.c_void_p * k)(*[f.data_ptr() for f in flats]),
                (ctypes.c_longlong * k)(*[f.numel() for f in flats]),
                (ctypes.c_void_p * k)(*[buf.data_ptr() + o
                                        for o in offs[:-1]]),
                (ctypes.c_uint * k)(*sizes))
        bytes_ = sum(4 * f.numel() + n for f, n in zip(flats, sizes))
        row, want = {"paint_cells": name, "indices": [f.numel() for f in flats],
                     "num_cells": sizes,
                     "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3}, None
        for variant, lib in libs.items():
            fn = lib.hs_paint_cell_sets
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5

            def call():
                buf.zero_()
                rc = fn(k, *args, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{variant}: CUDA error {rc}")

            row[f"{variant}_ms"] = time_ms(call, 20)[0]
            torch.cuda.synchronize()
            if want is None:
                want = buf.clone()
            else:
                row[f"{variant}_agrees"] = bool(torch.equal(buf, want))
        print(json.dumps(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from hector_slam_tpu_torch.probes import card
    libs = _build(_variants())
    _ablate_moments(libs["interp_moments"])
    _ablate_paint(libs["paint_cells"])
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
