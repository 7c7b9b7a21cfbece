"""MatchingFile / SolutionFile artifact codecs (copy of lfr_tpu/io/protos.py).

Byte-compatible with the reference's protobuf artifacts
(reference: types.proto:1-46; writers at two-view-refinement/
compute_match_graph.py:163-205 and multi-view-refinement/solve.cc:643-679).
The MatchingFile codec runs in host C++ by default (``use_native=True``:
``solver/native.py`` over ``csrc/lfr_native.cc``, as the JAX package's
default); ``use_native=False`` takes the numpy route, its plain version,
which encodes the per-match 2x(3x3) float displacement grids with vectorised
numpy and decodes straight into arrays.  Both give the same bytes and
arrays.  The port's C++ decoder keeps an empty ``image_name1`` empty, as the
numpy route does (the JAX package's moves ``image_name2`` there).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Iterable, List, Sequence

import numpy as np

from . import wire

GRID_CELLS = 9  # 3x3 flow samples per direction (reference: solve.cc:45).

# Single-byte tags (field numbers all < 16).
_PAIR_TAG = wire.tag_byte(1, wire.WIRETYPE_LEN)          # MatchingFile.image_pairs
_P_NAME1 = wire.tag_byte(1, wire.WIRETYPE_LEN)
_P_FACT1 = wire.tag_byte(2, wire.WIRETYPE_FIXED32)
_P_NAME2 = wire.tag_byte(3, wire.WIRETYPE_LEN)
_P_FACT2 = wire.tag_byte(4, wire.WIRETYPE_FIXED32)
_P_MATCH = wire.tag_byte(5, wire.WIRETYPE_LEN)
_M_IDX1 = wire.tag_byte(1, wire.WIRETYPE_VARINT)
_M_IDX2 = wire.tag_byte(2, wire.WIRETYPE_VARINT)
_M_SIM = wire.tag_byte(3, wire.WIRETYPE_FIXED32)
_M_DISP1 = wire.tag_byte(4, wire.WIRETYPE_LEN)
_M_DISP2 = wire.tag_byte(5, wire.WIRETYPE_LEN)
_D_DI = wire.tag_byte(1, wire.WIRETYPE_FIXED32)
_D_DJ = wire.tag_byte(2, wire.WIRETYPE_FIXED32)

_IMG_TAG = wire.tag_byte(1, wire.WIRETYPE_LEN)           # SolutionFile.images
_I_NAME = wire.tag_byte(1, wire.WIRETYPE_LEN)
_I_FACT = wire.tag_byte(2, wire.WIRETYPE_FIXED32)
_I_DISP = wire.tag_byte(3, wire.WIRETYPE_LEN)
_S_IDX = wire.tag_byte(1, wire.WIRETYPE_VARINT)
_S_DI = wire.tag_byte(2, wire.WIRETYPE_FIXED32)
_S_DJ = wire.tag_byte(3, wire.WIRETYPE_FIXED32)


@dataclasses.dataclass
class PairMatches:
    """Matches + two-view flow grids for one image pair.

    ``disp1`` holds the flow grid toward image 1 (i.e. the 2->1 estimates)
    and ``disp2`` the flow toward image 2 — the same storage convention as
    the reference writer (reference: compute_match_graph.py:178-187).
    Shapes: matches (N, 2) uint32, similarities (N,), disp* (N, 3, 3, 2)
    with the last axis ordered (di, dj).
    """

    image_name1: str
    fact1: float
    image_name2: str
    fact2: float
    matches: np.ndarray
    similarities: np.ndarray
    disp1: np.ndarray
    disp2: np.ndarray

    @property
    def num_matches(self) -> int:
        return int(self.matches.shape[0])


@dataclasses.dataclass
class ImageSolution:
    """Refined displacement per feature index for one image.

    Shapes: feature_indices (M,) uint32, displacements (M, 2) float32 with
    last axis (di, dj), in displacement units (1 unit = 16 px).
    """

    image_name: str
    fact: float
    feature_indices: np.ndarray
    displacements: np.ndarray


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _grid_block(grids: np.ndarray, outer_tag: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized encoding of (N, 3, 3, 2) flow grids.

    Emits, per match, nine length-prefixed Displacement submessages (always
    present, zero-length when both floats are 0 — matching proto3
    serialization of the reference writer's unconditional ``add()`` calls).
    Returns (data (N, 108), mask (N, 108)).
    """
    n = grids.shape[0]
    flat = np.ascontiguousarray(grids.reshape(n * GRID_CELLS, 2), dtype=np.float32)
    di_data, di_mask = wire.float32_columns(flat[:, 0], _D_DI)
    dj_data, dj_mask = wire.float32_columns(flat[:, 1], _D_DJ)
    body_len = di_mask[:, 0] * 5 + dj_mask[:, 0] * 5

    entry = np.empty((n * GRID_CELLS, 12), dtype=np.uint8)
    entry[:, 0] = outer_tag
    entry[:, 1] = body_len
    entry[:, 2:7] = di_data
    entry[:, 7:12] = dj_data
    mask = np.empty((n * GRID_CELLS, 12), dtype=bool)
    mask[:, 0] = True
    mask[:, 1] = True
    mask[:, 2:7] = di_mask
    mask[:, 7:12] = dj_mask
    return entry.reshape(n, -1), mask.reshape(n, -1)


def _encode_matches(pair: PairMatches) -> bytes:
    n = pair.num_matches
    if n == 0:
        return b""
    body = wire.RowCodec(n)
    body.add(*wire.uint_varint_columns(pair.matches[:, 0], _M_IDX1))
    body.add(*wire.uint_varint_columns(pair.matches[:, 1], _M_IDX2))
    body.add(*wire.float32_columns(pair.similarities, _M_SIM))
    body.add(*_grid_block(pair.disp1, _M_DISP1))
    body.add(*_grid_block(pair.disp2, _M_DISP2))

    full = wire.RowCodec(n)
    full.add(*wire.length_prefix_columns(body.row_lengths(), _P_MATCH, max_bytes=3))
    for data, mask in body.blocks:
        full.add(data, mask)
    out, _ = full.finish()
    return out


def _scalar_string(tag: int, value: str) -> bytes:
    raw = value.encode("utf-8")
    if not raw:
        return b""
    return bytes([tag]) + wire.encode_varint(len(raw)) + raw


def _scalar_float(tag: int, value: float) -> bytes:
    if value == 0.0:
        return b""
    return bytes([tag]) + struct.pack("<f", value)


def encode_matching_file(pairs: Sequence[PairMatches], use_native: bool = True) -> bytes:
    if use_native:
        from ..solver import native

        return native.encode_matching_file(pairs)
    out = bytearray()
    for pair in pairs:
        body = (
            _scalar_string(_P_NAME1, pair.image_name1)
            + _scalar_float(_P_FACT1, pair.fact1)
            + _scalar_string(_P_NAME2, pair.image_name2)
            + _scalar_float(_P_FACT2, pair.fact2)
            + _encode_matches(pair)
        )
        out.append(_PAIR_TAG)
        out += wire.encode_varint(len(body))
        out += body
    return bytes(out)


def encode_solution_file(images: Sequence[ImageSolution]) -> bytes:
    out = bytearray()
    for image in images:
        m = int(image.feature_indices.shape[0])
        disp = np.ascontiguousarray(image.displacements, dtype=np.float32)
        body = wire.RowCodec(m)
        body.add(*wire.uint_varint_columns(image.feature_indices, _S_IDX))
        body.add(*wire.float32_columns(disp[:, 0], _S_DI))
        body.add(*wire.float32_columns(disp[:, 1], _S_DJ))

        full = wire.RowCodec(m)
        full.add(*wire.length_prefix_columns(body.row_lengths(), _I_DISP, max_bytes=2))
        for data, mask in body.blocks:
            full.add(data, mask)
        disp_bytes, _ = full.finish()

        img_body = (
            _scalar_string(_I_NAME, image.image_name)
            + _scalar_float(_I_FACT, image.fact)
            + disp_bytes
        )
        out.append(_IMG_TAG)
        out += wire.encode_varint(len(img_body))
        out += img_body
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _skip_field(buf, pos: int, tag: int) -> int:
    wt = tag & 7
    if wt == wire.WIRETYPE_VARINT:
        _, pos = wire.decode_varint(buf, pos)
    elif wt == wire.WIRETYPE_FIXED32:
        pos += 4
    elif wt == wire.WIRETYPE_FIXED64:
        pos += 8
    elif wt == wire.WIRETYPE_LEN:
        ln, pos = wire.decode_varint(buf, pos)
        pos += ln
    else:
        raise ValueError(f"unsupported wire type {wt}")
    return pos


def _parse_displacement(buf, pos: int, end: int) -> tuple[float, float]:
    di = dj = 0.0
    while pos < end:
        tag = buf[pos]
        pos += 1
        if tag == _D_DI:
            di = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif tag == _D_DJ:
            dj = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        else:
            pos = _skip_field(buf, pos, tag)
    return di, dj


def _parse_match(buf, pos: int, end: int, disp1_out, disp2_out):
    idx1 = idx2 = 0
    sim = 0.0
    n1 = n2 = 0
    while pos < end:
        tag = buf[pos]
        pos += 1
        if tag == _M_DISP1 or tag == _M_DISP2:
            ln, pos = wire.decode_varint(buf, pos)
            d = _parse_displacement(buf, pos, pos + ln)
            if tag == _M_DISP1:
                if n1 < GRID_CELLS:
                    disp1_out[n1] = d
                n1 += 1
            else:
                if n2 < GRID_CELLS:
                    disp2_out[n2] = d
                n2 += 1
            pos += ln
        elif tag == _M_IDX1:
            idx1, pos = wire.decode_varint(buf, pos)
        elif tag == _M_IDX2:
            idx2, pos = wire.decode_varint(buf, pos)
        elif tag == _M_SIM:
            sim = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        else:
            pos = _skip_field(buf, pos, tag)
    return idx1, idx2, sim


def _parse_pair(buf, pos: int, end: int) -> PairMatches:
    name1 = name2 = ""
    fact1 = fact2 = 0.0
    idx_list: List[tuple] = []
    disp1_list: List[np.ndarray] = []
    disp2_list: List[np.ndarray] = []
    while pos < end:
        tag = buf[pos]
        pos += 1
        if tag == _P_MATCH:
            ln, pos = wire.decode_varint(buf, pos)
            d1 = np.zeros((GRID_CELLS, 2), dtype=np.float32)
            d2 = np.zeros((GRID_CELLS, 2), dtype=np.float32)
            idx_list.append(_parse_match(buf, pos, pos + ln, d1, d2))
            disp1_list.append(d1)
            disp2_list.append(d2)
            pos += ln
        elif tag == _P_NAME1 or tag == _P_NAME2:
            ln, pos = wire.decode_varint(buf, pos)
            s = bytes(buf[pos : pos + ln]).decode("utf-8")
            pos += ln
            if tag == _P_NAME1:
                name1 = s
            else:
                name2 = s
        elif tag == _P_FACT1 or tag == _P_FACT2:
            v = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
            if tag == _P_FACT1:
                fact1 = v
            else:
                fact2 = v
        else:
            pos = _skip_field(buf, pos, tag)

    n = len(idx_list)
    if n:
        arr = np.array(idx_list, dtype=np.float64)
        matches = arr[:, :2].astype(np.uint32)
        sims = arr[:, 2].astype(np.float32)
        disp1 = np.stack(disp1_list).reshape(n, 3, 3, 2)
        disp2 = np.stack(disp2_list).reshape(n, 3, 3, 2)
    else:
        matches = np.zeros((0, 2), dtype=np.uint32)
        sims = np.zeros((0,), dtype=np.float32)
        disp1 = np.zeros((0, 3, 3, 2), dtype=np.float32)
        disp2 = np.zeros((0, 3, 3, 2), dtype=np.float32)
    return PairMatches(name1, fact1, name2, fact2, matches, sims, disp1, disp2)


def decode_matching_file(data: bytes, use_native: bool = True) -> List[PairMatches]:
    if use_native:
        from ..solver import native

        return native.decode_matching_file(data)
    buf = memoryview(data)
    pos = 0
    end = len(buf)
    pairs: List[PairMatches] = []
    while pos < end:
        tag = buf[pos]
        pos += 1
        if tag == _PAIR_TAG:
            ln, pos = wire.decode_varint(buf, pos)
            pairs.append(_parse_pair(buf, pos, pos + ln))
            pos += ln
        else:
            pos = _skip_field(buf, pos, tag)
    return pairs


def decode_solution_file(data: bytes) -> List[ImageSolution]:
    buf = memoryview(data)
    pos = 0
    end = len(buf)
    images: List[ImageSolution] = []
    while pos < end:
        tag = buf[pos]
        pos += 1
        if tag != _IMG_TAG:
            pos = _skip_field(buf, pos, tag)
            continue
        ln, pos = wire.decode_varint(buf, pos)
        img_end = pos + ln
        name = ""
        fact = 0.0
        idxs: List[int] = []
        disps: List[tuple] = []
        while pos < img_end:
            tag = buf[pos]
            pos += 1
            if tag == _I_DISP:
                dln, pos = wire.decode_varint(buf, pos)
                dend = pos + dln
                fi = 0
                di = dj = 0.0
                while pos < dend:
                    t = buf[pos]
                    pos += 1
                    if t == _S_IDX:
                        fi, pos = wire.decode_varint(buf, pos)
                    elif t == _S_DI:
                        di = struct.unpack_from("<f", buf, pos)[0]
                        pos += 4
                    elif t == _S_DJ:
                        dj = struct.unpack_from("<f", buf, pos)[0]
                        pos += 4
                    else:
                        pos = _skip_field(buf, pos, t)
                idxs.append(fi)
                disps.append((di, dj))
            elif tag == _I_NAME:
                sln, pos = wire.decode_varint(buf, pos)
                name = bytes(buf[pos : pos + sln]).decode("utf-8")
                pos += sln
            elif tag == _I_FACT:
                fact = struct.unpack_from("<f", buf, pos)[0]
                pos += 4
            else:
                pos = _skip_field(buf, pos, tag)
        images.append(
            ImageSolution(
                name,
                fact,
                np.asarray(idxs, dtype=np.uint32),
                np.asarray(disps, dtype=np.float32).reshape(-1, 2),
            )
        )
    return images


# ---------------------------------------------------------------------------
# File helpers with .part.N chunking
# ---------------------------------------------------------------------------


def matching_file_parts(path: str) -> List[str]:
    """Resolve a matches path into its file list, honoring ``.part.N`` chunks
    (reference: solve.cc:412-424, colmap_utils.py:150-157)."""
    if os.path.exists(path):
        return [path]
    parts = []
    idx = 0
    while os.path.exists(f"{path}.part.{idx}"):
        parts.append(f"{path}.part.{idx}")
        idx += 1
    return parts


def read_matching_file(path: str) -> List[PairMatches]:
    pairs: List[PairMatches] = []
    files = matching_file_parts(path)
    if not files:
        raise FileNotFoundError(f"no matches file (or .part.N chunks) at {path}")
    for f in files:
        with open(f, "rb") as fh:
            pairs.extend(decode_matching_file(fh.read()))
    return pairs


def write_matching_file(path: str, pairs: Iterable[PairMatches]) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_matching_file(list(pairs)))


def read_solution_file(path: str) -> List[ImageSolution]:
    with open(path, "rb") as fh:
        return decode_solution_file(fh.read())


def write_solution_file(path: str, images: Iterable[ImageSolution]) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_solution_file(list(images)))
