"""Image IO: BMP (screenshot parity with SDL_SaveBMP output,
reference: source/Renderer.cpp:184-187) and PNG.

Both formats are written and read with numpy, ``struct`` and ``zlib`` only:
the BMP as a standard bottom-up 24-bit BI_RGB file, the PNG as 8-bit RGB,
non-interlaced.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_bmp(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB to a 24-bit BMP."""
    img = np.asarray(image)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    h, w, _ = img.shape
    row_size = (w * 3 + 3) & ~3
    pixel_bytes = row_size * h
    # BGR, bottom-up, row-padded to 4 bytes
    bgr = img[::-1, :, ::-1]
    rows = np.zeros((h, row_size), np.uint8)
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM",
        14 + 40 + pixel_bytes,
        0,
        0,
        14 + 40,
        40,
        w,
        h,
        1,
        24,
        0,
        pixel_bytes,
        2835,
        2835,
        0,
        0,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows.tobytes())


def read_bmp(path: str) -> np.ndarray:
    """Read a 24-bit BI_RGB BMP back to (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:2] == b"BM"
    offset = struct.unpack_from("<I", data, 10)[0]
    w = struct.unpack_from("<i", data, 18)[0]
    h = struct.unpack_from("<i", data, 22)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    assert bpp == 24, f"unsupported bpp {bpp}"
    row_size = (w * 3 + 3) & ~3
    flip = h > 0
    h = abs(h)
    arr = np.frombuffer(data, np.uint8, count=row_size * h, offset=offset)
    arr = arr.reshape(h, row_size)[:, : w * 3].reshape(h, w, 3)
    if flip:
        arr = arr[::-1]
    return arr[:, :, ::-1].copy()


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as an 8-bit RGB PNG (filter 0 rows)."""
    img = np.asarray(image)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA, non-interlaced PNG to (H, W, 3) uint8
    (alpha dropped).  Handles all five row filters."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == _PNG_MAGIC, "not a PNG file"
    pos, idat = 8, []
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    assert depth == 8 and ctype in (2, 6) and interlace == 0, "unsupported PNG layout"
    bpp = 3 if ctype == 2 else 4
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    out = np.zeros((h, stride), np.uint8)
    prev = bytearray(stride)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = bytearray(raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)])
        if ftype == 1:  # Sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            line = bytearray((a + b) & 0xFF for a, b in zip(line, prev))
        elif ftype == 3:  # Average
            for i in range(stride):
                left = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
        out[y] = np.frombuffer(bytes(line), np.uint8)
        prev = line
    return out.reshape(h, w, bpp)[:, :, :3].copy()


#: Largest fraction of pixels allowed to differ by more than 1 in any channel
#: between two renders of one frame: f32 reassociation and FMA contraction
#: legitimately flip isolated boundary pixels across compilers and versions.
FLIP_BUDGET = 0.002
#: Largest mean absolute channel difference allowed beside it.
MEAN_DIFF_BUDGET = 0.1


def flip_stats(image: np.ndarray, reference: np.ndarray) -> tuple[float, float]:
    """(fraction of pixels off by more than 1 in any channel, mean absolute
    channel difference) between two (H, W, 3) uint8 images."""
    diff = np.abs(np.asarray(image).astype(int) - np.asarray(reference).astype(int))
    return float((diff > 1).any(axis=-1).mean()), float(diff.mean())


def write_image(path: str, image: np.ndarray) -> None:
    if path.lower().endswith(".bmp"):
        write_bmp(path, image)
    else:
        write_png(path, image)
