"""The port's PNG reader (tpu_ray_torch/utils/image_io.read_png, numpy +
zlib) against the reference's (PIL), and its numeric sanitizers
(tpu_ray_torch/utils/debug.py), as tests/test_io_and_utils.py holds the
reference's.

Tolerances: the reader is exact against PIL (the same bytes, the same
float32 ops after them); a round trip through write_png is exact against
PIL's reading of the same file.
"""

import dataclasses
import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_ray.utils.image_io import read_png as pil_read_png
from tpu_ray_torch.utils.debug import assert_finite, checked, nan_debug
from tpu_ray_torch.utils.image_io import _chunk, read_png, tonemap_to_uint8, write_png


def _filters(data: bytes, stride: int) -> set:
    """The scanline filter types a PNG's image data uses."""
    pos, idat = 8, []
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * (stride + 1)] for y in range(len(raw) // (stride + 1))}


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_read_png_matches_pil_on_every_filter(tmp_path, mode):
    """PIL's optimizing writer picks a filter per scanline; on noise it
    takes all five (checked), so every filter's inverse is exercised."""
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (64, 48, len(mode)), dtype=np.uint8)
    path = tmp_path / "noise.png"
    Image.fromarray(px, mode).save(path, optimize=True)
    assert _filters(path.read_bytes(), 48 * len(mode)) == {0, 1, 2, 3, 4}
    got = read_png(str(path))
    assert got.dtype == np.float32 and got.shape == (64, 48, 3)
    np.testing.assert_array_equal(got, pil_read_png(str(path)))
    np.testing.assert_array_equal(read_png(str(path), gamma=1.0),
                                  px[..., :3].astype(np.float32) / 255.0)


def test_read_png_round_trips_write_png(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0.0, 1.0, (9, 13, 3)).astype(np.float32)
    path = tmp_path / "w.png"
    write_png(str(path), img)
    got = read_png(str(path))
    np.testing.assert_array_equal(got, pil_read_png(str(path)))
    np.testing.assert_array_equal(tonemap_to_uint8(got), tonemap_to_uint8(img))


def _raw_png(path, w, h, depth, ctype, interlace=0, data=b""):
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)))
        f.write(_chunk(b"IDAT", zlib.compress(data)))
        f.write(_chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray", "palette", "rgb16", "interlaced", "not-png"])
def test_read_png_refuses_other_pngs(tmp_path, kind):
    path = tmp_path / f"{kind}.png"
    if kind == "gray":
        Image.fromarray(np.zeros((4, 4), np.uint8), "L").save(path)
    elif kind == "palette":
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P").save(path)
    elif kind == "rgb16":
        _raw_png(path, 2, 2, 16, 2, data=bytes(2 * 13))
    elif kind == "interlaced":
        _raw_png(path, 2, 2, 8, 2, interlace=1, data=bytes(2 * 7))
    else:
        path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError):
        read_png(str(path))


def test_checked_raises_on_nan():
    f = checked(lambda x: torch.log(x) * 0.0 + torch.sqrt(x))
    f(torch.tensor([1.0, 2.0]))  # fine
    with pytest.raises(ValueError, match="non-finite"):
        f(torch.tensor([-1.0]))  # sqrt(-1) -> NaN
    g = checked(lambda x: {"img": x, "steps": [torch.tensor([1]), x / 0.0]})
    with pytest.raises(ValueError, match="steps"):
        g(torch.ones(2))


@dataclasses.dataclass
class _Leaves:
    a: torch.Tensor
    b: np.ndarray


def test_assert_finite():
    assert_finite({"a": torch.ones(3), "b": [np.ones(2), torch.arange(3)]})
    with pytest.raises(AssertionError, match=r"\['a'\]"):
        assert_finite({"a": torch.tensor([float("nan")])})
    with pytest.raises(AssertionError, match=r"\.b"):
        assert_finite(_Leaves(torch.ones(2), np.asarray([np.inf])))


def test_nan_debug_names_the_op():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="SqrtBackward"):
        with nan_debug():
            torch.sqrt(x).sum().backward()
    y = torch.tensor([1.0, 4.0], requires_grad=True)
    with nan_debug():
        torch.sqrt(y).sum().backward()
    assert bool(torch.isfinite(y.grad).all())
