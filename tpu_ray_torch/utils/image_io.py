"""Framebuffer output: gamma/clamp to 8-bit and a numpy + zlib PNG writer
(counterpart of `tpu_ray/utils/image_io.py`, without PIL)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap_to_uint8(img, gamma: float = 2.2) -> np.ndarray:
    """Linear float RGB (H, W, 3) -> uint8 with clamp + gamma encode."""
    arr = np.asarray(img, np.float64)
    arr = np.clip(arr, 0.0, 1.0) ** (1.0 / gamma)
    return (arr * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img, gamma: float = 2.2) -> None:
    """Write linear float RGB (H, W, 3) as an 8-bit RGB PNG."""
    px = tonemap_to_uint8(img, gamma)
    h, w, _ = px.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, w * 3)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
