"""PNG decoding and encoding with the standard library's ``zlib`` and numpy.

The port reads its images without OpenCV or PIL.  :func:`decode_png`
handles what a photo pipeline writes: 8-bit grayscale, RGB and RGBA,
non-interlaced, with any of the five row filters.  Palette, 16-bit and
interlaced files raise :class:`ValueError`.  :func:`encode_png` writes
8-bit RGB or grayscale with filter 0 (None) on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

#: Colour type -> channels, for the 8-bit types decoded here.
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    """Yield (type, payload) of each chunk, checking each CRC."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> (height, stride) uint8.  None, Sub and Up
    are vectorised across the row; Average and Paeth depend on the
    reconstructed left neighbour and run byte by byte."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8 (grayscale) or (H, W, 3|4) uint8."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header = None
    idat = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {color} "
            "(8-bit grayscale, RGB and RGBA are supported)"
        )
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    channels = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * channels, channels)
    if channels == 1:
        return pixels.reshape(height, width)
    return pixels.reshape(height, width, channels)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload)) + kind + payload
        + struct.pack(">I", zlib.crc32(kind + payload))
    )


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> PNG bytes, filter 0 on every row,
    deflated at level 1 (textured images barely compress at any level)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
        image.ndim == 3 and image.shape[2] != 3
    ):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got {image.shape} {image.dtype}")
    height, width = image.shape[:2]
    color = 0 if image.ndim == 2 else 2
    rows = np.zeros((height, 1 + image[0].size), np.uint8)
    rows[:, 1:] = image.reshape(height, -1)
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (
        SIGNATURE + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b"")
    )
