"""PNG I/O without an imaging library: 8-bit RGB written, and 8-bit
greyscale, RGB and RGBA read, with zlib."""

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


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
_COLOUR_NAMES = {3: "palette", 0: "greyscale", 2: "RGB", 4: "greyscale + alpha", 6: "RGBA"}


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG filters (none, sub, up, average, Paeth), row by row."""
    stride = w * bpp
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, expected {h * (stride + 1)}")
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (1, 3, 4):
            cur = line.copy()
            for x in range(stride):  # each byte depends on the one bpp before it
                a = int(cur[x - bpp]) if x >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + int(prev[x])) >> 1
                else:
                    b, c = int(prev[x]), int(prev[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[x] = (int(line[x]) + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {kind} in row {y}")
        out[y] = cur
        prev = cur
    return out


def load_png(path: str) -> np.ndarray:
    """Load an 8-bit greyscale, RGB or RGBA PNG as float32 (H, W, 3) in [0,
    1]: alpha is dropped and grey is repeated in the three channels, as
    PIL's ``convert("RGB")`` does. Palette, 16-bit and interlaced images are
    refused by name."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path!r} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path!r} has no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    name = _COLOUR_NAMES.get(colour, f"colour type {colour}")
    if colour not in _CHANNELS:
        raise ValueError(f"{path!r}: {name} PNGs are not read (8-bit greyscale, RGB or RGBA)")
    if depth != 8:
        raise ValueError(f"{path!r}: {depth}-bit {name} PNGs are not read (8-bit only)")
    if interlace:
        raise ValueError(f"{path!r}: interlaced PNGs are not read")
    n = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, n).reshape(h, w, n)
    rgb = np.repeat(pixels[..., :1], 3, axis=2) if n <= 2 else pixels[..., :3]
    return rgb.astype(np.float32) / 255.0
