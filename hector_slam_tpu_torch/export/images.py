"""Map-as-image export: the hector_compressed_map_transport equivalents
(src/map_to_image_node.cpp) plus dependency-free PGM/PNG writers (replaces
OpenCV/cv_bridge/image_transport).

A numpy copy of ``hector_slam_tpu/export/images.py``
(the port imports nothing of the JAX package); it takes numpy
arrays, and the session hands it host copies of its tensors.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from .occupancy import GridMeta


def map_to_image(occ_grid: np.ndarray) -> np.ndarray:
    """Full map as MONO8, y-flipped (image y starts at top, map y at
    bottom), {-1 -> 127, 0 -> 255, 100 -> 0}
    (map_to_image_node.cpp:99-140)."""
    g = np.asarray(occ_grid)
    img = np.full(g.shape, 127, np.uint8)
    img[g == 0] = 255
    img[g == 100] = 0
    return img[::-1]


def map_tile_image(occ_grid: np.ndarray, meta: GridMeta,
                   robot_world_xy, tile_w: int = 64, tile_h: int = 64
                   ) -> np.ndarray:
    """Robot-centered tile with edge clamping
    (map_to_image_node.cpp:143-235): the tile window is shifted (not
    shrunk) when it would leave the map."""
    g = np.asarray(occ_grid)
    size_y, size_x = g.shape
    rob = meta.world_to_map(robot_world_xy).astype(np.int32)
    min_x = int(rob[0]) - tile_w // 2
    min_y = int(rob[1]) - tile_h // 2
    min_x = max(min_x, 0)
    min_y = max(min_y, 0)
    max_x = min_x + tile_w
    max_y = min_y + tile_h
    if max_x > size_x:
        min_x -= max_x - size_x
        max_x = size_x
    if max_y > size_y:
        min_y -= max_y - size_y
        max_y = size_y
    tile = g[min_y:max_y, min_x:max_x]
    img = np.full(tile.shape, 127, np.uint8)
    img[tile == 0] = 255
    img[tile == 100] = 0
    return img[::-1]


# ---- writers ---------------------------------------------------------------


def write_pgm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG writer (stdlib zlib only). Accepts uint8 [H,W] (gray)
    or [H,W,3] (RGB)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        color_type = 0
        row_len = img.shape[1]
        data = img
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        row_len = img.shape[1] * 3
        data = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"unsupported image shape {img.shape}")

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload))

    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + data[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png_size(path: str) -> Tuple[int, int]:
    """(width, height) from a PNG header — test helper."""
    with open(path, "rb") as f:
        head = f.read(26)
    w, h = struct.unpack(">II", head[16:24])
    return w, h
