"""Reader and writer of the PANet weight files (``weights/panet_*.msgpack``).

The files are written by ``flax.serialization.to_bytes``: one msgpack map of
string keys, nested, whose leaves are msgpack extension values of type 1.
Each such payload is itself msgpack, ``[shape, dtype name, raw bytes]`` in C
order.  This module decodes exactly that subset of msgpack (maps, strings,
arrays, binary, extensions and integers) with ``struct``, and encodes it
with msgpack's shortest forms, as flax's ``to_bytes`` does (its bytes for
the same tree, in the tree's key order), so the port needs neither flax nor
the ``msgpack`` package.  :func:`load_any` also reads the reference's torch
``checkpoint.pth`` (:mod:`.torch_import`).
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

#: flax's extension codes for an ndarray leaf and a numpy scalar leaf.
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


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
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not an ndarray")
        shape, dtype, data = _Reader(bytes(self.take(n))).value()
        arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]


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


def _uint(n: int, fix_max: int, fix_tag: int, tags) -> bytes:
    """A length or count in msgpack's shortest form: the fix form below
    ``fix_max``, else the first of the 1/2/4-byte forms ``tags`` that holds it."""
    if fix_max and n < fix_max:
        return bytes([fix_tag | n])
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} is too large")


def _int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if n <= limit:
                return bytes([tag]) + struct.pack(fmt, n)
    for tag, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31), (0xD3, ">q", 63)):
        if n >= -(2**bits):
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _str(text: str) -> bytes:
    raw = text.encode("utf-8")
    return _uint(len(raw), 32, 0xA0, (0xD9, 0xDA, 0xDB)) + raw


def _ext(code: int, payload: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    head = bytes([fixed[n]]) if n in fixed else _uint(n, 0, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _ndarray(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, C bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    raw = arr.tobytes("C")
    shape = _uint(arr.ndim, 16, 0x90, (None, 0xDC, 0xDD)) + b"".join(_int(int(d)) for d in arr.shape)
    return (b"\x93" + shape + _str(arr.dtype.name)
            + _uint(len(raw), 0, 0, (0xC4, 0xC5, 0xC6)) + raw)


def _encode(value) -> bytes:
    if isinstance(value, dict):
        out = [_uint(len(value), 16, 0x80, (None, 0xDE, 0xDF))]
        for key, item in value.items():
            out.append(_str(str(key)))
            out.append(_encode(item))
        return b"".join(out)
    if isinstance(value, np.ndarray):
        return _ext(_EXT_NDARRAY, _ndarray(value))
    if isinstance(value, np.generic):
        return _ext(_EXT_NPSCALAR, _ndarray(np.asarray(value)))
    raise TypeError(f"cannot write a {type(value).__name__} leaf; use numpy arrays")


def dumps(variables: Dict) -> bytes:
    """Encode a nested dict of arrays as ``flax.serialization.to_bytes``
    does, keys in the dict's own order."""
    if not isinstance(variables, dict):
        raise TypeError("a flax checkpoint is a dict at the top level")
    return _encode(variables)


def save_variables(path: str, variables: Dict) -> None:
    """Write a variable tree in the JAX layout (see :func:`dumps`)."""
    with open(path, "wb") as fh:
        fh.write(dumps(variables))


def load_any(path: str) -> Dict:
    """Read a framework checkpoint (.msgpack) or a torch .pth / .pt."""
    if path.endswith((".pth", ".pt")):
        from .torch_import import load_checkpoint

        return load_checkpoint(path)
    return load_variables(path)
