"""Point-cloud pictures for ``test_seg --visualize`` (counterpart of
ogc_tpu/utils/visual.py, which draws with matplotlib).

``segm_colors`` is a copy of the JAX package's palette (the reference's
utils/visual_util.py colours).  ``scatter_segm_png`` writes a PNG with
numpy and zlib only: the points projected orthographically from the view
the JAX package's 3D scatter takes (axes x, z, y; elevation 20, azimuth
-60 degrees), drawn far to near as 3 x 3 pixel dots on white.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# 20-color object palette (tab20-style), background drawn in gray.
COLOR20 = (
    np.array(
        [
            [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
            [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
            [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
            [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
            [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
        ]
    )
    / 255.0
)


def segm_colors(segm: np.ndarray, with_background: bool = False) -> np.ndarray:
    """(N,) ids -> (N, 3) colors; id 0 is gray when with_background."""
    segm = np.asarray(segm).astype(int)
    colors = COLOR20[segm % len(COLOR20)]
    if with_background:
        colors = np.where(
            (segm == 0)[:, None], np.array([[0.75, 0.75, 0.75]]), colors
        )
    return colors


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], 1)  # filter type 0
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def scatter_segm_png(pc, segm, path: str, with_background: bool = False,
                     elev: float = 20.0, azim: float = -60.0,
                     size: int = 512) -> None:
    """Save the points ``pc`` (N, 3) coloured by segment ``segm`` (N,) as a
    ``size`` x ``size`` PNG."""
    pc = np.asarray(pc, np.float64)
    p = pc[:, [0, 2, 1]]  # the scatter's axes: x, z, then y up
    p = p - (p.min(0) + p.max(0)) / 2
    e, a = np.radians(elev), np.radians(azim)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    toward = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                       np.sin(e)])
    up = np.cross(toward, right)
    u, v, depth = p @ right, p @ up, p @ toward
    extent = max(np.abs(u).max(), np.abs(v).max(), 1e-9)
    scale = (size / 2 - 4) / extent
    col = np.clip(np.round(size / 2 + u * scale), 1, size - 2).astype(int)
    row = np.clip(np.round(size / 2 - v * scale), 1, size - 2).astype(int)
    colors = np.round(segm_colors(segm, with_background) * 255).astype(
        np.uint8)
    img = np.full((size, size, 3), 255, np.uint8)
    order = np.argsort(depth, kind="stable")  # far first, near drawn last
    off = np.arange(-1, 2)
    rr = (row[order][:, None, None] + off[None, :, None]).repeat(3, 2)
    cc = (col[order][:, None, None] + off[None, None, :]).repeat(3, 1)
    img[rr.ravel(), cc.ravel()] = colors[order].repeat(9, 0)
    write_png(path, img)
