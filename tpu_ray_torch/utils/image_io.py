"""Framebuffer I/O: gamma/clamp to 8-bit, and a numpy + zlib PNG writer
and reader (counterpart of `tpu_ray/utils/image_io.py`, without PIL).

The reader takes what a fit target needs: 8-bit RGB or RGBA (alpha
dropped, as PIL's convert("RGB") drops it), not interlaced, with any of
the five scanline filters; it refuses every other PNG."""

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


_CHANNELS = {2: 3, 6: 4}  # PNG colour type -> samples a pixel (RGB, RGBA)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters -> (h, stride) uint8."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1)
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum of each sample lane
            cur = (np.cumsum(line.reshape(-1, bpp), 0, dtype=np.uint64) % 256
                   ).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: byte by byte
            b, f, c = prior.tolist(), line.tolist(), bytearray(stride)
            for x in range(stride):
                left = c[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    c[x] = (f[x] + ((left + b[x]) >> 1)) & 0xFF
                else:
                    ul = b[x - bpp] if x >= bpp else 0
                    c[x] = (f[x] + _paeth(left, b[x], ul)) & 0xFF
            cur = np.frombuffer(bytes(c), np.uint8)
        else:
            raise ValueError(f"PNG scanline {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str, gamma: float = 2.2) -> np.ndarray:
    """8-bit RGB or RGBA PNG -> linear float32 RGB (H, W, 3) in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise ValueError(f"{path}: read_png takes 8-bit RGB or RGBA PNGs, not "
                         f"interlaced; this one has bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (w * ch + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for {w}x{h}x{ch}")
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)[..., :3]
    arr = px.astype(np.float32) / 255.0
    return arr ** gamma
