"""Run-once geotiff saver: load a SLAM checkpoint (or replay a scan log),
render the map to <base>.png + <base>.tfw, and exit.

    python -m hector_slam_tpu_torch.save_geotiff --checkpoint state.npz \
        --out /tmp/map
    python -m hector_slam_tpu_torch.save_geotiff --log scans.npz \
        --out /tmp/map --resolution 0.05 --size 1024 --levels 3

Counterpart of the JAX package's ``tools/save_geotiff.py``, the
reference's standalone saver node (hector_geotiff/src/geotiff_saver.cpp:
121: a one-shot node that waits for one map message, writes the geotiff
and exits), with the same flags. The input is a checkpoint
(``io/checkpoint.py``: either package's npz) or a scan log
(``io/scanlog.py``) replayed first through ``run_log_jit``, whose poses
are drawn as the trajectory. ``--device`` (default ``cuda``) is where the
state lives; without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="SLAM state .npz (io/checkpoint)")
    src.add_argument("--log", help="scan log .npz to replay (io/scanlog)")
    ap.add_argument("--out", required=True,
                    help="output base path (writes <out>.png + <out>.tfw)")
    ap.add_argument("--resolution", type=float, default=0.05)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--no-coords", action="store_true",
                    help="skip the coordinate/scale overlay")
    ap.add_argument("--no-grid", action="store_true",
                    help="skip the 0.5 m explored-space grid")
    ap.add_argument("--device", default="cuda",
                    help="where the state lives: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .config import MapConfig, SlamConfig
    from .core.slam import init_state, run_log_jit
    from .export.geotiff import write_geotiff
    from .export.occupancy import grid_meta, to_occupancy_grid
    from .io.checkpoint import load_state
    from .io.scanlog import load_log, scan_from_ranges, stack_scans
    from .types import resolve_device

    device = resolve_device(args.device)
    cfg = SlamConfig(map=MapConfig(
        resolution=args.resolution, size_x=args.size, size_y=args.size,
        levels=args.levels))

    path_world = None
    if args.checkpoint:
        state = load_state(args.checkpoint, cfg, device=device)
    else:
        ranges, laser, _ = load_log(args.log)
        scans = stack_scans([
            scan_from_ranges(r, 1.0 / cfg.map.resolution, laser,
                             cfg.max_beams, device=device) for r in ranges])
        state, poses, _ = run_log_jit(init_state(cfg, device), scans, cfg)
        path_world = poses.cpu().numpy()[:, :2]

    occ = to_occupancy_grid(state.log_odds[0], cfg.update.cell_model)
    png, tfw = write_geotiff(
        occ, grid_meta(cfg.map, level=0), args.out, path_world=path_world,
        draw_explored_grid=not args.no_grid,
        draw_coords=not args.no_coords)
    print(f"wrote {png} and {tfw}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
