"""Image output helpers (PNG encode of RGBA u8 frames).

The reference encodes PNGs with the Rust ``image`` crate
(src/lib.rs:330-333, src/terrain/mod.rs:487-490). Here the standard
library (zlib + struct) encodes them; output is a deterministic function
of the pixel bytes.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def png_bytes_rgba(img: np.ndarray) -> bytes:
    """8-bit RGBA PNG (colour type 6, no interlace, filter 0 on every row)."""
    h, w = img.shape[0], img.shape[1]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 4)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_png_rgba(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 4) uint8 RGBA array as a PNG file."""
    img = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
    if img.ndim != 3 or img.shape[2] != 4:
        raise RuntimeError("Invalid image buffer")
    with open(path, "wb") as f:
        f.write(png_bytes_rgba(img))
