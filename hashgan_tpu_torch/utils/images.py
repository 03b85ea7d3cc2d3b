"""Image-grid dumps for watching the GAN (port of
``hashgan_tpu/utils/images.py``): one PNG per dump, ``samples_<step>.png``.

The PNG is written here with ``zlib`` and ``struct`` (8-bit grey or RGB,
no filtering), so the port needs no imaging library.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """(H, W) or (H, W, 3) uint8 -> an 8-bit greyscale or RGB PNG file."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    color = 2 if image.ndim == 3 else 0
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                            0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def save_image_grid(images: np.ndarray, path: str, n_cols: int = 0) -> None:
    """Tile (N, H, W, C) images (uint8, or float in [-1, 1] or [0, 1]) into
    one PNG, ``ceil(sqrt(N))`` columns unless ``n_cols`` is given, row by
    row, the unused cells black."""
    images = np.asarray(images)
    if images.dtype != np.uint8:
        lo, hi = float(images.min()), float(images.max())
        if lo < 0:  # [-1, 1]
            images = (images + 1.0) * 127.5
        elif hi <= 1.0:
            images = images * 255.0
        images = np.clip(images, 0, 255).astype(np.uint8)
    n, h, w, c = images.shape
    cols = n_cols or int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, c), dtype=np.uint8)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    write_png(path, grid[:, :, 0] if c == 1 else grid)
