"""Reader for the PANet weight files (``weights/panet_*.msgpack``).

The files are written by ``flax.serialization.to_bytes``: one msgpack map of
string keys, nested, whose leaves are msgpack extension values of type 1.
Each such payload is itself msgpack, ``[shape, dtype name, raw bytes]`` in C
order.  This module decodes exactly that subset of msgpack (maps, strings,
arrays, binary, extensions and integers) with ``struct``, so the port needs
neither flax nor the ``msgpack`` package.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

#: flax's extension code for an ndarray leaf.
_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self):
        tag = self.unpack(">B")
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.value() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        if tag in _INTS:
            return self.unpack(_INTS[tag])
        if tag in _STR_LEN:
            return str(self.take(self.unpack(_STR_LEN[tag])), "utf-8")
        if tag in _BIN_LEN:
            return bytes(self.take(self.unpack(_BIN_LEN[tag])))
        if tag in _ARRAY_LEN:
            return [self.value() for _ in range(self.unpack(_ARRAY_LEN[tag]))]
        if tag in _MAP_LEN:
            return self.map(self.unpack(_MAP_LEN[tag]))
        if tag in _EXT_LEN:
            n = self.unpack(_EXT_LEN[tag])
            return self.ext(self.unpack(">b"), n)
        if tag in _FIXEXT_LEN:
            return self.ext(self.unpack(">b"), _FIXEXT_LEN[tag])
        raise ValueError(f"msgpack type byte 0x{tag:02x} is not supported")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int) -> np.ndarray:
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack extension type {code} is not an ndarray")
        shape, dtype, data = _Reader(bytes(self.take(n))).value()
        return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()


_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY_LEN = {0xDC: ">H", 0xDD: ">I"}
_MAP_LEN = {0xDE: ">H", 0xDF: ">I"}
_EXT_LEN = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def loads(data: bytes) -> Dict:
    """Decode one flax msgpack checkpoint -> nested dict of numpy arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack checkpoint")
    if not isinstance(tree, dict):
        raise ValueError("a flax checkpoint is a msgpack map at the top level")
    return tree


def load_variables(path: str) -> Dict:
    """Read a PANet variable tree ({"params": ..., "batch_stats": ...}) in
    the JAX package's layout (conv kernels HWIO, dense kernels (in, out))."""
    with open(path, "rb") as fh:
        return loads(fh.read())
