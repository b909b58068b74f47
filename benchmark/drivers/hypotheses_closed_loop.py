"""Batches of pose hypotheses matched against one map through
``match_hypotheses_kernel_jit``, closed loop (relocalization and
multi-hypothesis scoring).

Set-up: the seed's lap; the map built from the lap's first ``map_scans``
scans at their true poses (``slam_step`` with the known pose); and
``batches`` batches, each of ``hypotheses`` poses drawn about the true
pose of one of the lap's first ``pose_span_scans`` scans (sigma
``sigma_xy_m`` / ``sigma_theta_rad``) with that scan; one call to
capture the matcher's graph. Window: call after call for ``seconds``, the
next enqueued as soon as the one before it is (at most ``in_flight``
queued), batch i mod ``batches`` in call i. The last ``checked_calls``
calls' poses are copied aside on the card. Judged: every hypothesis's
pose of those calls against the reference's match from the same start on
the reference's map rebuilt from the same scans and poses
(``judge.hypothesis_gaps``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import judge, slam_ref
from ..sim import traffic as sim
from . import common


def main(run) -> None:
    import hector_slam_tpu_torch as hs

    cell, tr = run.cell, run.cell.traffic
    dev = torch.device(run.device)
    cfg = common.slam_config(hs, cell.config)
    laps = sim.make_laps(tr, cell.config["laser"], 1, run.seed, dev)
    pts, mask = sim.scans_from_ranges(laps.ranges[0], cell.config["laser"],
                                      cfg.map.level_scale(0), cfg.max_beams)
    true = torch.tensor(laps.poses[0], dtype=torch.float32, device=dev)
    origo = torch.zeros(2, dtype=torch.float32, device=dev)
    n_map = int(tr["map_scans"])
    state = hs.init_state(cfg, dev)
    for j in range(n_map):
        state, _ = hs.slam_step(state, hs.Scan(pts[j], origo, mask[j]), cfg,
                                pose_hint=true[j], map_without_matching=True)

    n_hyp, n_sets = int(tr["hypotheses"]), int(tr["batches"])
    rng = np.random.default_rng(sim.seed_int(run.seed) ^ 0x5EED)
    scan_of = rng.integers(0, tr["pose_span_scans"], n_sets)
    gen = torch.Generator(device=dev)
    gen.manual_seed(sim.seed_int(run.seed) ^ 0x5EED)
    sigma = torch.tensor([tr["sigma_xy_m"], tr["sigma_xy_m"],
                          tr["sigma_theta_rad"]], device=dev)
    hyps = (true[torch.from_numpy(scan_of).to(dev)][:, None, :]
            + sigma * torch.randn((n_sets, n_hyp, 3), generator=gen,
                                  device=dev))
    checked = int(tr["checked_calls"])
    out = torch.empty((checked, n_hyp, 3), dtype=torch.float32, device=dev)
    levels, quads = state.log_odds, state.quads

    def call(i):
        k = i % n_sets
        j = int(scan_of[k])
        with run.tracer.span("entry.match_hypotheses_kernel_jit"):
            res, _ = hs.match_hypotheses_kernel_jit(
                levels, hyps[k], hs.Scan(pts[j], origo, mask[j]), cfg,
                quads=quads)
        with run.tracer.span("copy.outputs"):
            out[i % checked].copy_(res.pose)

    call(0)
    run.tracer.warm()
    sync = (torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))
    sync()
    events = [torch.cuda.Event() if dev.type == "cuda" else None
              for _ in range(tr["in_flight"])]
    traced = range(tr["traced_from"], tr["traced_from"] + tr["traced_calls"])
    run.setup_done()

    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < run.seconds:
        if k == traced.start:
            run.tracer.start()
        if k == traced.stop:
            run.tracer.stop()
        call(1 + k)
        if events[0] is not None:
            with run.tracer.span("traffic.wait_in_flight"):
                events[k % len(events)].record()
                events[(k + 1) % len(events)].synchronize()
        k += 1
    sync()
    window_s = time.perf_counter() - t0
    run.tracer.stop()
    calls = 1 + k

    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.attempted = k * n_hyp
    run.e2e["matches_per_s"] = k * n_hyp / window_s
    run.note(f"window {window_s:.3f} s: {k} calls of {n_hyp} hypotheses, "
             f"{run.e2e['matches_per_s']:.1f} matches/s")
    traced_sets = [(1 + i) % n_sets for i in traced] if k >= traced.stop \
        else []
    run.info["traced_calls"] = len(traced_sets)
    run.info["work"] = dict(
        hyps=hyps[traced_sets], pts=pts[scan_of[traced_sets]],
        mask=mask[scan_of[traced_sets]],
        true=true[torch.from_numpy(scan_of[traced_sets]).to(dev)])

    first = max(0, calls - checked)
    done = [(i, i % checked, i % n_sets) for i in range(first, calls)]
    poses = out.cpu()
    run.failed = common.non_finite(poses.numpy().reshape(-1, 3))
    del state, levels, quads, out
    common.free_program(dev)

    t_ref = time.perf_counter()
    p = slam_ref.params(cell.config)

    def reference(dtype):
        """The reference's poses of the checked calls, matched in
        ``dtype`` on a map it builds in ``dtype``."""
        maps = slam_ref.init_maps(p, 1, dev, dtype)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        for j in range(n_map):
            slam_ref.update(p, maps, zero, true[j][None].to(dtype),
                            pts[j][None].to(dtype), origo[None].to(dtype),
                            mask[j][None])
        probs = [slam_ref.probabilities(m) for m in maps]
        return torch.stack([slam_ref.match(
            p, probs, zero.expand(n_hyp), hyps[k].to(dtype),
            pts[int(scan_of[k])].to(dtype), mask[int(scan_of[k])])
            .to(torch.float64).cpu() for _, _, k in done])

    ref = reference(torch.float64)
    ours = torch.stack([poses[slot] for _, slot, _ in done])
    run.checks.update(judge.hypothesis_gaps(ours, ref))
    xy, th, _ = judge.gaps(ours, ref)
    goal = torch.stack([true[int(scan_of[k])].cpu() for _, _, k in done])
    near, _, _ = judge.gaps(ref, goal[:, None, :].expand(ref.shape))
    conv = near < judge.CONVERGED_M
    run.info["off"] = {f"{m}m": int((xy > m).sum())
                       for m in (0.005, 0.01, 0.02, 0.05)}
    run.note(f"reference: {len(done)} calls of {n_hyp} hypotheses judged "
             f"in {time.perf_counter() - t_ref:.2f} s; xy gaps "
             f"{judge.spread_of(xy)}; theta gaps {judge.spread_of(th)}; "
             f"{float(conv.double().mean()):.4f} of the reference's poses "
             f"within {judge.CONVERGED_M} m of the true pose, their xy gaps "
             f"{judge.spread_of(xy[conv])}, the others' "
             f"{judge.spread_of(xy[~conv]) if bool((~conv).any()) else '-'}"
             f"; gaps over 0.005/0.01/0.02/0.05 m: "
             f"{'/'.join(str(v) for v in run.info['off'].values())}")
    if run.info.get("with_control"):
        run.info["control"] = judge.hypothesis_gaps(
            reference(torch.bfloat16), ref)
