"""Image export: a dependency-free PNG writer (zlib + struct).

Port of ``save_png`` from ``bsdmg_tpu/mesh/export.py``; the mesh exporters
come with the mesh-generation slice.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def save_png(image: np.ndarray, path: str | Path) -> None:
    """Write an (H, W, 3|4) uint8 image as PNG (zlib + struct, no deps)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0).astype(np.uint8)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    h, w, c = image.shape
    color_type = {3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF
        )

    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)
