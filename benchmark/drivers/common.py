"""Helpers the drivers share: the program's configuration from a
configuration file, the open loop's clock, and freeing the program's
state before the reference runs."""

from __future__ import annotations

import time

import numpy as np

LASER_FIELDS = ("num_beams", "angle_min", "angle_increment", "range_min",
                "range_max")


def slam_config(hs, cfg: dict):
    """The program's ``SlamConfig`` of a configuration file's fields."""
    m = dict(cfg["map"])
    m["start_coords"] = tuple(m["start_coords"])
    top = {k: cfg[k] for k in ("map_update_distance_thresh",
                               "map_update_angle_thresh", "max_beams",
                               "max_ray_cells")}
    return hs.SlamConfig(map=hs.MapConfig(**m),
                         match=hs.MatchConfig(**cfg["match"]),
                         update=hs.UpdateConfig(**cfg["update"]), **top)


def laser_model(hs, cfg: dict):
    return hs.LaserModel(**{k: cfg["laser"][k] for k in LASER_FIELDS})


def wait_until(due: float) -> None:
    """Spins until ``due`` on ``time.perf_counter``'s clock: a sleep on a
    shared host wakes up to milliseconds late, and the open loop's scans
    are due on time."""
    while time.perf_counter() < due:
        pass


def free_program(device) -> None:
    """Drops the program's kept graphs and cached blocks, so the reference
    has the card's memory."""
    import torch
    from hector_slam_tpu_torch.core import graphs
    graphs.clear()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def non_finite(poses: np.ndarray) -> int:
    return int((~np.isfinite(poses)).any(-1).sum())
