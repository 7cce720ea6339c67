"""PNG and BMP IO without PIL (raytpu/utils/image.py): round trips and all
five PNG row filters."""

import struct
import zlib

import numpy as np
import pytest

from raytpu.utils import image


@pytest.mark.parametrize("shape", [(1, 1), (17, 23), (48, 64)])
def test_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    image.write_png(path, img)
    np.testing.assert_array_equal(image.read_png(path), img)


def _encode(img, ftype):
    """A PNG whose every row uses filter ``ftype`` (the PNG spec's filters)."""
    h, w, c = img.shape
    bpp, stride = c, w * c
    raw = img.reshape(h, stride).astype(int)
    out = bytearray()
    prev = np.zeros(stride, int)
    for y in range(h):
        line = raw[y]
        left = np.concatenate([np.zeros(bpp, int), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, int), prev[:-bpp]])
        if ftype == 0:
            f = line
        elif ftype == 1:
            f = line - left
        elif ftype == 2:
            f = line - prev
        elif ftype == 3:
            f = line - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            f = line - pred
        out.append(ftype)
        out.extend((f % 256).astype(np.uint8).tobytes())
        prev = line
    ctype = 2 if c == 3 else 6
    return (image._PNG_MAGIC
            + image._png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + image._png_chunk(b"IDAT", zlib.compress(bytes(out)))
            + image._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_row_filters(tmp_path, ftype):
    img = np.random.default_rng(ftype).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, ftype))
    np.testing.assert_array_equal(image.read_png(str(path)), img)


def test_png_rgba_drops_alpha(tmp_path):
    img = np.random.default_rng(7).integers(0, 256, (5, 6, 4), dtype=np.uint8)
    path = tmp_path / "a.png"
    path.write_bytes(_encode(img, 4))
    np.testing.assert_array_equal(image.read_png(str(path)), img[:, :, :3])


def test_write_image_picks_format(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    img[1, 2] = (10, 200, 30)
    image.write_image(str(tmp_path / "a.bmp"), img)
    image.write_image(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(image.read_bmp(str(tmp_path / "a.bmp")), img)
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "a.png")), img)


def test_flip_stats():
    a = np.zeros((10, 10, 3), np.uint8)
    b = a.copy()
    b[0, 0, 1] = 1  # one quantization step: not a flip
    b[5, 5, 0] = 9
    flipped, mean_diff = image.flip_stats(b, a)
    assert flipped == pytest.approx(0.01)
    assert mean_diff == pytest.approx(10 / 300)
