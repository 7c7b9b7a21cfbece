"""Low-level protobuf wire-format helpers, NumPy-vectorized (copy of lfr_tpu/io/wire.py).

The framework keeps the reference's protobuf artifact formats
(reference: types.proto:1-46) for interop, but implements the wire codec
directly: a dependency-free, vectorized encoder beats generic protobuf
python for the million-float displacement grids, and the decoder feeds
straight into NumPy arrays without intermediate message objects.

Wire format essentials (proto3 canonical serialization):
  * varint:   little-endian base-128, msb = continuation.
  * tag:      varint((field_number << 3) | wire_type).
  * float:    wire type 5, 4 bytes little-endian IEEE754.
  * message:  wire type 2, varint length + body.
  * scalar fields equal to their default (0 / 0.0 / "") are omitted;
    repeated message entries are always emitted (possibly zero-length).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

WIRETYPE_VARINT = 0
WIRETYPE_FIXED64 = 1
WIRETYPE_LEN = 2
WIRETYPE_FIXED32 = 5


def tag_byte(field_number: int, wire_type: int) -> int:
    """Single-byte tag; valid for field numbers 1..15."""
    assert 1 <= field_number <= 15
    return (field_number << 3) | wire_type


def encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf, pos: int) -> Tuple[int, int]:
    """Returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def varint_columns(values: np.ndarray, max_bytes: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized varint encoding of an array of non-negative ints.

    Returns ``(data, mask)`` with shape (N, max_bytes) uint8 / bool; valid
    bytes are left-aligned.  Values must fit in ``7 * max_bytes`` bits.
    """
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[0]
    data = np.zeros((n, max_bytes), dtype=np.uint8)
    mask = np.zeros((n, max_bytes), dtype=bool)
    remaining = values.copy()
    for col in range(max_bytes):
        byte = (remaining & np.uint64(0x7F)).astype(np.uint8)
        remaining = remaining >> np.uint64(7)
        more = remaining != 0
        data[:, col] = np.where(more, byte | 0x80, byte)
        # A column is valid if it's the first one or the value still had bits.
        mask[:, col] = True if col == 0 else prev_more
        prev_more = more if col == 0 else (prev_more & more)
    if np.any(remaining):
        raise ValueError(f"varint overflow for max_bytes={max_bytes}")
    return data, mask


class RowCodec:
    """Assembles per-row byte strings from fixed-width column blocks + masks.

    Each block is (data (N, K) uint8, mask (N, K) bool).  ``finish`` returns
    the concatenation of masked bytes in row-major order, plus per-row
    lengths — the vectorized analogue of building one submessage per row.
    """

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self.blocks: List[Tuple[np.ndarray, np.ndarray]] = []

    def add(self, data: np.ndarray, mask: np.ndarray) -> None:
        assert data.shape == mask.shape and data.shape[0] == self.n_rows
        self.blocks.append((data.astype(np.uint8, copy=False), mask))

    def add_const(self, byte_values: bytes) -> None:
        k = len(byte_values)
        data = np.tile(np.frombuffer(byte_values, dtype=np.uint8), (self.n_rows, 1))
        self.add(data, np.ones((self.n_rows, k), dtype=bool))

    def row_lengths(self) -> np.ndarray:
        if not self.blocks:
            return np.zeros(self.n_rows, dtype=np.int64)
        return sum(m.sum(axis=1, dtype=np.int64) for _, m in self.blocks)

    def finish(self) -> Tuple[bytes, np.ndarray]:
        if not self.blocks:
            return b"", np.zeros(self.n_rows, dtype=np.int64)
        data = np.hstack([d for d, _ in self.blocks])
        mask = np.hstack([m for _, m in self.blocks])
        return data[mask].tobytes(), mask.sum(axis=1, dtype=np.int64)


def float32_columns(values: np.ndarray, tag: int) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a float32 column as optional fixed32 fields (omitted when 0).

    Returns (data (N,5), mask (N,5)): tag byte + 4 LE bytes, masked out
    entirely for zero values (proto3 default skipping).
    """
    values = np.ascontiguousarray(values, dtype=np.float32)
    n = values.shape[0]
    raw = values.view(np.uint8).reshape(n, 4)
    data = np.empty((n, 5), dtype=np.uint8)
    data[:, 0] = tag
    data[:, 1:] = raw
    nz = values != 0.0
    mask = np.repeat(nz[:, None], 5, axis=1)
    return data, mask


def uint_varint_columns(values: np.ndarray, tag: int, max_bytes: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a uint column as optional varint fields (omitted when 0)."""
    values = np.asarray(values)
    n = values.shape[0]
    vdata, vmask = varint_columns(values, max_bytes)
    data = np.empty((n, 1 + max_bytes), dtype=np.uint8)
    data[:, 0] = tag
    data[:, 1:] = vdata
    nz = values != 0
    mask = np.empty((n, 1 + max_bytes), dtype=bool)
    mask[:, 0] = nz
    mask[:, 1:] = vmask & nz[:, None]
    return data, mask


def length_prefix_columns(lengths: np.ndarray, tag: int, max_bytes: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Tag + varint(length) columns for wrapping per-row submessages."""
    n = lengths.shape[0]
    vdata, vmask = varint_columns(lengths, max_bytes)
    data = np.empty((n, 1 + max_bytes), dtype=np.uint8)
    data[:, 0] = tag
    data[:, 1:] = vdata
    mask = np.empty((n, 1 + max_bytes), dtype=bool)
    mask[:, 0] = True
    mask[:, 1:] = vmask
    return data, mask


def ragged_indices(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """indices [starts[i] .. starts[i]+lengths[i]) concatenated (ragged ranges)."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out = np.arange(total, dtype=np.int64)
    offs = np.repeat(np.cumsum(lengths) - lengths, lengths)
    return out - offs + np.repeat(starts, lengths)
