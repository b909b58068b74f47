"""The least bytes one launch of the map update's paint kernel
(``raster_paint_kernel``) moves by itself, on a shared map: each scan's
pose, sine, cosine and origo (28 bytes), each scan slot's mask byte
(``max_beams`` a robot, padding included), each painted beam's point (two
f32; a beam is painted where its mask is set and its robot's gate fired)
and one byte for each distinct cell the launch stores, over the free and
occupied grids of every level. An input is counted once, however many
levels read it (L2 can serve the repeats), and a cell that many beams
store counts once.

The stored cells are counted by the plain reference: the union of the
gated robots' free and occupied cells (``reference/slam_ref.update`` of
their scans into a zeroed map, at the program's poses of the tick). The
program's own sets can differ from it only where float32 and float64
round a ray's cells differently.

Not counted: the wrapper's zero fill of the grids (``ops/raster_paint.py``),
a launch of its own that the reader does not time. The kernel's time is
therefore no less than these bytes over the card's HBM bandwidth.
"""

from __future__ import annotations

import torch

from ..reference import slam_ref

SCAN_BYTES = 28    # a scan's pose (3 f32), sine, cosine and origo (2 f32)
MASK_BYTES = 1     # a scan slot's mask
POINT_BYTES = 8    # a painted beam's point (2 f32)


def launch_bytes(scans: int, slots: int, painted_beams: int,
                 stored_cells: int) -> int:
    """Bytes one launch moves at least: ``scans`` scans of ``slots`` scan
    slots in all, ``painted_beams`` of them painted, ``stored_cells``
    distinct cells stored."""
    return (SCAN_BYTES * scans + MASK_BYTES * slots
            + POINT_BYTES * painted_beams + stored_cells)


def stored_cells(p: slam_ref.Params, poses: torch.Tensor,
                 points: torch.Tensor, origo: torch.Tensor,
                 mask: torch.Tensor) -> int:
    """Distinct cells one shared map's paint of G scans stores, every
    level's free and occupied cells in one union: the cells that
    ``slam_ref.update`` of the scans (world poses [G, 3], points [G, N, 2]
    and origo [G, 2] in finest-level map units, mask [G, N]) changes in a
    zeroed map, where both log-odds deltas are nonzero."""
    maps = slam_ref.init_maps(p, 1, poses.device, torch.float64)
    slam_ref.update(p, maps, torch.zeros(poses.shape[0], dtype=torch.int64,
                                         device=poses.device),
                    poses.to(torch.float64), points.to(torch.float64),
                    origo.to(torch.float64), mask)
    return sum(int((m != 0).sum()) for m in maps)


def tick_bytes(p: slam_ref.Params, max_beams: int, poses: torch.Tensor,
               gated: torch.Tensor, points: torch.Tensor,
               origo: torch.Tensor, mask: torch.Tensor) -> int:
    """``launch_bytes`` of one shared-map tick's paint: R robots' scans
    of ``max_beams`` slots at the program's poses [R, 3], their gates
    bool [R], points [R, N, 2], origo [R, 2] and mask [R, N]."""
    idx = torch.nonzero(gated.to(mask.device)).reshape(-1)
    robots = poses.shape[0]
    return launch_bytes(
        robots, robots * max_beams, int(mask[idx].sum()),
        stored_cells(p, poses.to(mask.device)[idx], points[idx],
                     origo[idx], mask[idx]))
