"""Raycast map queries — the hector_map_server equivalents.

Counterpart of ``hector_slam_tpu/query/raycast.py``. The scalar queries
are numpy, as there, and take the port's ``GridMeta``:
``distance_to_obstacle`` replicates HectorMapTools::
DistanceMeasurementProvider (HectorMapTools.h:118-239): a Bresenham walk
from the start until a cell reads 100 (occupied), at most 5000 cells, the
integer-truncated cell distance scaled back to meters.
``get_distance_to_obstacle`` wraps it with the map_server service
semantics (hector_map_server.cpp:91-165): the ray capped to 5 m from the
robot toward the query point, slant-corrected for 3D queries.
``get_search_position`` offsets a pose backwards along its heading
(hector_map_server.cpp:167-261).

``distance_to_obstacle_batch`` raycasts many rays at once in torch ops on
the grid's device: the fleet-scale query path the reference has no
analog for.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..export.occupancy import GridMeta
from ..types import host_array, resolve_device

MAX_RAY_CELLS = 5000  # HectorMapTools.h:190,197 cap


def distance_to_obstacle(occ_grid, meta: GridMeta, begin_world, end_world,
                         ) -> Tuple[float, Optional[np.ndarray]]:
    """Returns (distance_m, hit_world) — (-1.0, None) when no hit or the
    ray leaves the map. Distance is the reference's
    ``resolution * float(int(norm(cell_delta)))`` (the int truncation is
    a reference quirk, HectorMapTools.h:201). ``occ_grid``: int8 [H, W]
    {-1, 0, 100}, numpy or a tensor on any device."""
    g = host_array(occ_grid)
    size_y, size_x = g.shape
    b = meta.world_to_map(host_array(begin_world)).astype(np.int32)
    e = meta.world_to_map(host_array(end_world)).astype(np.int32)
    x0, y0 = int(b[0]), int(b[1])
    x1, y1 = int(e[0]), int(e[1])
    if not (0 <= x0 < size_x and 0 <= y0 < size_y):
        return -1.0, None
    if not (0 <= x1 < size_x and 0 <= y1 < size_y):
        return -1.0, None
    dx, dy = x1 - x0, y1 - y0
    abs_dx, abs_dy = abs(dx), abs(dy)
    off_dx = 1 if dx > 0 else -1
    off_dy = (1 if dy > 0 else -1) * size_x
    offset = y0 * size_x + x0
    if abs_dx >= abs_dy:
        abs_da, abs_db, off_a, off_b = abs_dx, abs_dy, off_dx, off_dy
    else:
        abs_da, abs_db, off_a, off_b = abs_dy, abs_dx, off_dy, off_dx
    err = abs_da // 2
    flat = g.reshape(-1)
    end_offset = -1
    for _ in range(min(MAX_RAY_CELLS, abs_da)):
        if flat[offset] == 100:
            end_offset = offset
            break
        offset += off_a
        err += abs_db
        if err >= abs_da:
            offset += off_b
            err -= abs_da
    if end_offset < 0:
        return -1.0, None
    hx, hy = end_offset % size_x, end_offset // size_x
    dist_cells = float(int(math.hypot(x0 - hx, y0 - hy)))  # int truncation!
    hit_world = meta.map_to_world(np.asarray([hx, hy], np.float32))
    return float(np.float32(meta.resolution) * np.float32(dist_cells)), \
        hit_world


def get_distance_to_obstacle(occ_grid, meta: GridMeta, robot_world,
                             point_world) -> float:
    """Service semantics (hector_map_server.cpp:110-135): cast a ray 5 m
    from the robot toward the (possibly 3D) query point; slant-correct
    the 2D map distance by the ray's out-of-plane angle."""
    v1 = host_array(robot_world).astype(np.float64)
    v2 = host_array(point_world).astype(np.float64)
    if v1.shape[0] == 2:
        v1 = np.append(v1, 0.0)
    if v2.shape[0] == 2:
        v2 = np.append(v2, 0.0)
    diff = v2 - v1
    norm2d = math.hypot(diff[0], diff[1])
    if norm2d == 0.0:
        return -1.0
    v2 = v1 + diff / norm2d * 5.0
    dist, _ = distance_to_obstacle(occ_grid, meta, v1[:2], v2[:2])
    if dist < 0.0:
        return -1.0
    d3 = v2 - v1
    cos_angle = math.hypot(d3[0], d3[1]) / math.sqrt(float(np.dot(d3, d3)))
    return dist / cos_angle


def get_normal(occ_grid, meta: GridMeta, robot_world, point_world,
               window_m: float = 0.4) -> Optional[np.ndarray]:
    """Estimated obstacle surface normal at the raycast hit toward
    ``point_world`` — the hector_nav_msgs/GetNormal service surface (the
    reference declares the service type but ships no server; the
    estimator is the JAX package's: PCA over the occupied cells in a
    ``window_m`` neighborhood of the hit, normal = the minor eigenvector,
    oriented back toward the robot).

    Returns a unit (nx, ny) or None when the ray hits nothing."""
    g = host_array(occ_grid)
    robot = host_array(robot_world).astype(np.float64)
    _, hit_world = distance_to_obstacle(g, meta, robot,
                                        host_array(point_world)[:2])
    if hit_world is None:
        return None
    hc = meta.world_to_map(hit_world).astype(int)
    r = max(1, int(round(window_m / meta.resolution)))
    y0, y1 = max(hc[1] - r, 0), min(hc[1] + r + 1, g.shape[0])
    x0, x1 = max(hc[0] - r, 0), min(hc[0] + r + 1, g.shape[1])
    ys, xs = np.nonzero(g[y0:y1, x0:x1] == 100)
    if len(xs) < 2:
        # isolated hit: fall back to the reversed ray direction
        d = robot[:2] - hit_world
        n = np.linalg.norm(d)
        return (d / n).astype(np.float32) if n > 0 else None
    pts = np.stack([xs + x0, ys + y0], -1).astype(np.float64)
    centered = pts - pts.mean(axis=0)
    cov = centered.T @ centered / len(pts)
    _, evecs = np.linalg.eigh(cov)
    normal = evecs[:, 0]                    # minor axis of the wall strip
    if np.dot(normal, robot[:2] - hit_world) < 0:
        normal = -normal
    return (normal / np.linalg.norm(normal)).astype(np.float32)


def get_search_position(ooi_pose, distance: float) -> np.ndarray:
    """Offset the object-of-interest pose backwards along its heading by
    ``distance`` (hector_map_server.cpp:184-189)."""
    pose = host_array(ooi_pose).astype(np.float64)
    c, s = math.cos(pose[2]), math.sin(pose[2])
    return np.asarray([pose[0] + c * -distance,
                       pose[1] + s * -distance,
                       pose[2]], np.float32)


# ---- batched raycast in torch ops ------------------------------------------


def distance_to_obstacle_batch(occ_grid, begins_map, ends_map,
                               max_cells: int = 1024,
                               device="cuda") -> torch.Tensor:
    """Raycasts R rays at once: begins and ends are integer map cells
    [R, 2]; returns cell distances f32[R] (-1 where no hit), on the
    grid's device. ``occ_grid`` is int8 [H, W] {-1, 0, 100}: a tensor
    stays on its device; a numpy grid is placed on ``device`` (the card
    unless the caller asks for the CPU).

    The closed-form Bresenham of the map update evaluates every candidate
    cell of every ray at once, and the first occupied one is found with an
    argmax over the step axis. So a call holds several [R, max_cells]
    int32 tensors (offsets, minor steps, their products): 65,536 rays x
    1024 steps is 256 MB each, about 1 GB at the peak."""
    if isinstance(occ_grid, torch.Tensor):
        g = occ_grid
    else:
        g = torch.from_numpy(np.asarray(occ_grid)).to(resolve_device(device))
    dev = g.device
    begins = torch.as_tensor(begins_map, dtype=torch.int32, device=dev)
    ends = torch.as_tensor(ends_map, dtype=torch.int32, device=dev)
    h, w = g.shape
    flat = g.reshape(-1)
    bx, by = begins[:, 0], begins[:, 1]
    ex, ey = ends[:, 0], ends[:, 1]
    valid = ((bx >= 0) & (bx < w) & (by >= 0) & (by < h)
             & (ex >= 0) & (ex < w) & (ey >= 0) & (ey < h))
    dx, dy = ex - bx, ey - by
    abs_dx, abs_dy = dx.abs(), dy.abs()
    one = torch.ones((), dtype=torch.int32, device=dev)
    off_dx = torch.where(dx > 0, one, -one)
    off_dy = torch.where(dy > 0, one, -one) * w
    x_dom = abs_dx >= abs_dy
    abs_da = torch.where(x_dom, abs_dx, abs_dy)
    abs_db = torch.where(x_dom, abs_dy, abs_dx)
    off_a = torch.where(x_dom, off_dx, off_dy)
    off_b = torch.where(x_dom, off_dy, off_dx)
    start = by * w + bx
    da = torch.clamp(abs_da, min=1)
    steps = torch.arange(max_cells, dtype=torch.int32, device=dev)[None, :]
    # floor division, as jnp's // (the numerator is never negative here)
    minor = torch.div((abs_da // 2)[:, None] + steps * abs_db[:, None],
                      da[:, None], rounding_mode="floor")
    offs = start[:, None] + steps * off_a[:, None] + minor * off_b[:, None]
    in_ray = (steps < torch.clamp(abs_da, max=MAX_RAY_CELLS)[:, None]) \
        & valid[:, None]
    offs = torch.clamp(offs, 0, h * w - 1)
    occ = (flat.index_select(0, offs.reshape(-1)).reshape(offs.shape)
           == 100) & in_ray
    # first occupied step per ray: argmax over a uint8 copy (argmax on
    # bool is not defined) returns the first maximal index
    first = occ.to(torch.uint8).argmax(dim=1)
    hit = occ.any(dim=1)
    hit_off = offs.gather(1, first[:, None])[:, 0]
    hx = hit_off % w
    hy = torch.div(hit_off, w, rounding_mode="floor")
    dist = torch.sqrt((bx - hx).to(torch.float32) ** 2
                      + (by - hy).to(torch.float32) ** 2)
    # the reference's int truncation
    dist = torch.floor(dist)
    return torch.where(hit, dist, -1.0)
