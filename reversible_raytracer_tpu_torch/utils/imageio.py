"""PNG output without an imaging library: 8-bit RGB written with zlib."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_uint8(image) -> np.ndarray:
    """(H, W, 3) floats in [0, 1] (a tensor or array) -> uint8."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    img = np.asarray(image)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, image) -> None:
    """Save an (H, W, 3) float image in [0, 1] (or uint8) as PNG."""
    arr = image if getattr(image, "dtype", None) == np.uint8 else to_uint8(image)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(png)
