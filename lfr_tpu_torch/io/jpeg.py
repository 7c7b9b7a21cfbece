"""Baseline JPEG decoding with numpy, equal bit for bit to ``cv2.imread``.

The JAX package reads its images with ``cv2.imread(path)[:, :, ::-1]``, so
the port decodes as libjpeg(-turbo) does under OpenCV's settings:

- markers SOI, APPn (APP0 JFIF, APP1 Exif and APP14 Adobe read, the rest
  skipped), COM, DQT (8- and 16-bit tables), SOF0 and SOF1 at 8 bits,
  DHT, DRI with RSTn, SOS (interleaved or one component per scan), EOI;
- Huffman decoding of the byte-stuffed entropy data, with the DC
  prediction per component reset at each restart, EOB and ZRL, and the
  zig-zag order (in Python, one 32-bit window per coefficient);
- libjpeg's ``JDCT_ISLOW`` integer IDCT (``jidctint.c``: ``CONST_BITS``
  13, ``PASS1_BITS`` 2, its range-limit table), as integer column and row
  passes over all blocks at once;
- libjpeg's "fancy" upsampling (``jdsample.c``): h2v1 and h1v2 with the
  3:1 triangle filter and biases +1 / +2, h2v2 with its column sums and
  biases +8 / +7, edge columns and rows replicated at the component's
  downsampled size; other integer ratios by replication;
- libjpeg's fixed-point YCbCr -> RGB (``jdcolor.c``, ``SCALEBITS`` 16);
  grayscale becomes three equal channels;
- the EXIF orientation of IFD0, applied as ``cv2.imread`` applies it.

Progressive, lossless, hierarchical, arithmetic-coded, 12-bit and CMYK
files raise :class:`ValueError` naming the mode.

:func:`image_size` reads a JPEG's SOF or a PNG's IHDR, unrotated (as
PIL's ``Image.size``), and :func:`exif_focal_35mm` reads
``FocalLengthIn35mmFilm`` from IFD0 only, as PIL's ``getexif()`` returns
it to the JAX package's dataset tools.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .png import SIGNATURE as PNG_SIGNATURE

#: Zig-zag index -> natural (row-major) index within an 8x8 block.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

_UNSUPPORTED_SOF = {
    0xC2: "progressive (SOF2)",
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}

#: libjpeg's post-IDCT range limit: sample = table[value & 1023].
_RANGE = np.concatenate([
    np.arange(128, 256), np.full(384, 255), np.zeros(384), np.arange(0, 128),
]).astype(np.uint8)

_MASK = [(1 << s) - 1 for s in range(33)]
_HALF = [0] + [1 << (s - 1) for s in range(1, 33)]

#: A marker that ends a scan's entropy data: 0xFF followed by neither a
#: stuffed 0x00 nor a restart marker.
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")


def _huffman_lut(counts: bytes, symbols: bytes) -> List[int]:
    """16-bit lookup table of a canonical Huffman code: entry
    (length << 8) | symbol for every 16-bit prefix, 0 for no code."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("corrupt JPEG Huffman table")
            lo = code << (16 - length)
            lut[lo : lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(buf: bytes) -> List[int]:
    """For each byte offset i, bytes i..i+5 of ``buf`` (zero-padded) as one
    48-bit big-endian integer."""
    n = len(buf)
    p = np.frombuffer(buf + bytes(8), np.uint8).astype(np.int64)
    w = np.zeros(n + 1, np.int64)
    for j in range(6):
        w = (w << 8) | p[j : j + n + 1]
    return w.tolist()


def _decode_interval(buf, blocks, dc_luts, ac_luts, idxs, vals):
    """Huffman-decode ``blocks`` (a list of (component slot, coefficient
    offset)) from one restart interval's unstuffed bytes; appends each
    block's DC and nonzero AC coefficients' offsets and values to
    ``idxs[slot]`` and ``vals[slot]``."""
    win = _windows(buf)
    limit = len(buf) * 8 + 32
    zz = ZIGZAG.tolist()
    mask, half = _MASK, _HALF
    pred = [0] * len(dc_luts)
    pos = 0
    try:
        for slot, base in blocks:
            off = pos & 7
            t = (win[pos >> 3] >> (16 - off)) & 0xFFFFFFFF
            e = dc_luts[slot][t >> 16]
            length = e >> 8
            if not length:
                raise ValueError("corrupt JPEG: no DC Huffman code matches")
            s = e & 0xFF
            if s:
                v = (t >> (32 - length - s)) & mask[s]
                if v < half[s]:
                    v -= mask[s]
                pred[slot] += v
            pos += length + s
            idx = idxs[slot].append
            val = vals[slot].append
            idx(base)
            val(pred[slot])
            lut = ac_luts[slot]
            k = 1
            while k < 64:
                off = pos & 7
                t = (win[pos >> 3] >> (16 - off)) & 0xFFFFFFFF
                e = lut[t >> 16]
                length = e >> 8
                if not length:
                    raise ValueError("corrupt JPEG: no AC Huffman code matches")
                s = e & 15
                if s:
                    k += (e >> 4) & 15
                    v = (t >> (32 - length - s)) & mask[s]
                    if v < half[s]:
                        v -= mask[s]
                    idx(base + zz[k])
                    val(v)
                    pos += length + s
                    k += 1
                elif e & 0xF0 == 0xF0:
                    pos += length
                    k += 16
                else:
                    pos += length
                    break
            if pos > limit:
                raise ValueError("corrupt JPEG: entropy data ends inside a block")
    except IndexError:
        raise ValueError("corrupt JPEG: entropy data ends inside a block") from None


def _idct_1d(x, shift: int):
    """One 8-point pass of jidctint.c's jpeg_idct_islow on int64 arrays;
    returns the 8 outputs descaled by ``shift`` bits."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3 = z3 * -16069 + z5
    z4 = z4 * -3196 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    rnd = 1 << (shift - 1)
    return [
        (tmp10 + t3 + rnd) >> shift, (tmp11 + t2 + rnd) >> shift,
        (tmp12 + t1 + rnd) >> shift, (tmp13 + t0 + rnd) >> shift,
        (tmp13 - t0 + rnd) >> shift, (tmp12 - t1 + rnd) >> shift,
        (tmp11 - t2 + rnd) >> shift, (tmp10 - t3 + rnd) >> shift,
    ]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) coefficients in natural order and their (64,) quantization
    table -> (N, 8, 8) uint8 samples, as libjpeg's jpeg_idct_islow."""
    b = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    # Pass 1: columns (along the block's rows axis), scaled by 2**PASS1_BITS.
    ws = np.stack(_idct_1d([b[:, k, :] for k in range(8)], 13 - 2), axis=1)
    # Pass 2: rows, descaled by 8 and 2**PASS1_BITS.
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], 13 + 2 + 3), axis=2)
    return _RANGE[out & 1023]


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg's upsampling of a (h, w) component plane by (fh, fv)."""
    x = plane.astype(np.int32)
    h, w = x.shape
    if (fh, fv) == (1, 1):
        return x
    up = np.concatenate([x[:1], x[:-1]], 0)      # row above, first replicated
    down = np.concatenate([x[1:], x[-1:]], 0)    # row below, last replicated
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    if (fh, fv) == (2, 1) and w > 2:
        out = np.empty((h, 2 * w), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        out[:, 0] = x[:, 0]
        out[:, -1] = x[:, -1]
        return out
    if (fh, fv) == (1, 2):
        out = np.empty((2 * h, w), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out
    if (fh, fv) == (2, 2) and w > 2:
        out = np.empty((2 * h, 2 * w), np.int32)
        for r, other in ((0, up), (1, down)):
            cs = 3 * x + other
            cl = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
            cr = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
            rows = out[r::2]
            rows[:, 0::2] = (3 * cs + cl + 8) >> 4
            rows[:, 1::2] = (3 * cs + cr + 7) >> 4
            rows[:, 0] = (cs[:, 0] * 4 + 8) >> 4
            rows[:, -1] = (cs[:, -1] * 4 + 7) >> 4
        return out
    return np.repeat(np.repeat(x, fv, 0), fh, 1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on int32 planes."""
    cbx = cb - 128
    crx = cr - 128
    r = y + ((91881 * crx + 32768) >> 16)
    g = y + ((-22554 * cbx + 32768 - 46802 * crx) >> 16)
    b = y + ((116130 * cbx + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _exif_ifd0(payload: bytes) -> Dict[int, object]:
    """IFD0 of an APP1 Exif payload (after "Exif\\0\\0"): tag -> value for
    SHORT and LONG entries of count 1 (what orientation and the 35 mm
    focal length are)."""
    if len(payload) < 8 or payload[:2] not in (b"II", b"MM"):
        return {}
    end = "<" if payload[:2] == b"II" else ">"
    (offset,) = struct.unpack_from(end + "I", payload, 4)
    if offset + 2 > len(payload):
        return {}
    (count,) = struct.unpack_from(end + "H", payload, offset)
    tags = {}
    for i in range(count):
        entry = offset + 2 + 12 * i
        if entry + 12 > len(payload):
            break
        tag, kind, n = struct.unpack_from(end + "HHI", payload, entry)
        if n != 1:
            continue
        if kind == 3:
            tags[tag] = struct.unpack_from(end + "H", payload, entry + 8)[0]
        elif kind == 4:
            tags[tag] = struct.unpack_from(end + "I", payload, entry + 8)[0]
    return tags


def _segments(data: bytes):
    """Yield (marker, payload start, payload end, next marker) of each marker
    segment up to EOI; the payload excludes the length bytes, and after an
    SOS the next marker lies past the scan's entropy-coded data."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos = 2
    while pos + 2 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: expected a marker at byte {pos}")
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        marker = data[pos + 1]
        if marker == 0xD9:
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        if pos + 4 > len(data):
            break
        (length,) = struct.unpack_from(">H", data, pos + 2)
        a, b = pos + 4, pos + 2 + length
        pos = b
        if marker == 0xDA:
            end = _SCAN_END.search(data, b)
            pos = end.start() if end else len(data)
        yield marker, a, b, pos
    raise ValueError("truncated JPEG file (no EOI marker)")


def _app1_exif(data: bytes) -> Dict[int, object]:
    for marker, a, b, _ in _segments(data):
        if marker == 0xE1 and data[a : a + 6] == b"Exif\x00\x00":
            return _exif_ifd0(data[a + 6 : b])
        if marker == 0xDA:
            break
    return {}


def _orient(image: np.ndarray, orientation) -> np.ndarray:
    """OpenCV's ExifTransform for orientations 2-8."""
    if orientation in (5, 6, 7, 8):
        image = image.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flips:
        image = np.flip(image, axis)
    return np.ascontiguousarray(image)


class _Frame:
    def __init__(self, data: bytes, a: int, marker: int):
        precision, self.height, self.width, n = struct.unpack_from(">BHHB", data, a)
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG is not supported (8-bit only)")
        if self.height == 0:
            raise ValueError("JPEG with its height in a DNL marker is not supported")
        if n not in (1, 3):
            kind = "CMYK / 4-component" if n == 4 else f"{n}-component"
            raise ValueError(f"{kind} JPEG is not supported")
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = struct.unpack_from(">BBB", data, a + 6 + 3 * i)
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.h), max(self.v)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        # Block grid of each component (padded to whole MCUs).
        self.bw = [self.mcux * h for h in self.h]
        self.bh = [self.mcuy * v for v in self.v]
        # Each component's size before upsampling (libjpeg's downsampled_*).
        self.cw = [-(-self.width * h // self.hmax) for h in self.h]
        self.ch = [-(-self.height * v // self.vmax) for v in self.v]


def _scan_blocks(frame: _Frame, comps: List[int]):
    """Decode order of a scan's blocks: (MCU count, blocks per MCU, list of
    (slot in ``comps``, flat coefficient offset in the component))."""
    if len(comps) == 1:
        c = comps[0]
        rows, cols = -(-frame.ch[c] // 8), -(-frame.cw[c] // 8)
        r, q = np.divmod(np.arange(rows * cols), cols)
        offsets = (r * frame.bw[c] + q) * 64
        return rows * cols, 1, [(0, o) for o in offsets.tolist()]
    per_mcu = []
    for slot, c in enumerate(comps):
        for by in range(frame.v[c]):
            for bx in range(frame.h[c]):
                per_mcu.append((slot, c, by, bx))
    n_mcu = frame.mcux * frame.mcuy
    my, mx = np.divmod(np.arange(n_mcu), frame.mcux)
    columns = []
    for slot, c, by, bx in per_mcu:
        columns.append(((my * frame.v[c] + by) * frame.bw[c] + mx * frame.h[c] + bx) * 64)
    offsets = np.stack(columns, 1).reshape(-1).tolist()
    slots = [s for s, *_ in per_mcu] * n_mcu
    return n_mcu, len(per_mcu), list(zip(slots, offsets))


def decode_jpeg(data: bytes, apply_orientation: bool = True) -> np.ndarray:
    """Decode a baseline JPEG to (H, W, 3) uint8 RGB, as
    ``cv2.imread(path)[:, :, ::-1]`` gives it (EXIF orientation applied)."""
    quant: Dict[int, np.ndarray] = {}
    dc_tables: Dict[int, List[int]] = {}
    ac_tables: Dict[int, List[int]] = {}
    frame: Optional[_Frame] = None
    restart = 0
    jfif = False
    adobe_transform = None
    orientation = 1
    coefs: Dict[int, Tuple[list, list]] = {}
    comp_quant: Dict[int, np.ndarray] = {}

    for marker, a, b, scan_end in _segments(data):
        if marker in (0xC0, 0xC1):
            frame = _Frame(data, a, marker)
        elif marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{_UNSUPPORTED_SOF[marker]} JPEG is not supported")
        elif marker == 0xCC:
            raise ValueError("arithmetic-coded JPEG (DAC) is not supported")
        elif marker == 0xC4:
            while a < b:
                tc_th = data[a]
                counts = data[a + 1 : a + 17]
                n = sum(counts)
                table = _huffman_lut(counts, data[a + 17 : a + 17 + n])
                (ac_tables if tc_th >> 4 else dc_tables)[tc_th & 15] = table
                a += 17 + n
        elif marker == 0xDB:
            while a < b:
                pq_tq = data[a]
                if pq_tq >> 4:
                    zz = np.frombuffer(data[a + 1 : a + 129], ">u2").astype(np.int64)
                    a += 129
                else:
                    zz = np.frombuffer(data[a + 1 : a + 65], np.uint8).astype(np.int64)
                    a += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = zz
                quant[pq_tq & 15] = table
        elif marker == 0xDD:
            (restart,) = struct.unpack_from(">H", data, a)
        elif marker == 0xE0 and data[a : a + 5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xE1 and data[a : a + 6] == b"Exif\x00\x00":
            orientation = _exif_ifd0(data[a + 6 : b]).get(0x0112, 1)
        elif marker == 0xEE and data[a : a + 5] == b"Adobe" and b - a >= 12:
            adobe_transform = data[a + 11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: SOS before SOF")
            ns = data[a]
            comps, dcs, acs = [], [], []
            for i in range(ns):
                cid, td_ta = data[a + 1 + 2 * i], data[a + 2 + 2 * i]
                c = frame.ids.index(cid)
                comps.append(c)
                dcs.append(dc_tables[td_ta >> 4])
                acs.append(ac_tables[td_ta & 15])
                if c not in comp_quant:
                    if frame.tq[c] not in quant:
                        raise ValueError("corrupt JPEG: a component's quantization table is missing")
                    comp_quant[c] = quant[frame.tq[c]]
            intervals = _RESTART.split(data[b:scan_end])
            n_mcu, per_mcu, blocks = _scan_blocks(frame, comps)
            span = (restart or n_mcu) * per_mcu
            needed = -(-len(blocks) // span)
            if len(intervals) < needed:
                raise ValueError("corrupt JPEG: fewer restart intervals than MCUs")
            idxs = [[] for _ in comps]
            vals = [[] for _ in comps]
            for j in range(needed):
                raw = intervals[j].replace(b"\xff\x00", b"\xff")
                _decode_interval(raw, blocks[j * span : (j + 1) * span], dcs, acs, idxs, vals)
            for slot, c in enumerate(comps):
                coefs[c] = (np.asarray(idxs[slot], np.int64), np.asarray(vals[slot], np.int64))
    if frame is None:
        raise ValueError("JPEG without a frame header")

    planes = []
    for c in range(len(frame.ids)):
        n = frame.bh[c] * frame.bw[c]
        coef = np.zeros(n * 64, np.int64)
        if c in coefs:
            idx, val = coefs[c]
            coef[idx] = val
        samples = idct_islow(coef.reshape(n, 64), comp_quant.get(c, np.zeros(64, np.int64)))
        plane = samples.reshape(frame.bh[c], frame.bw[c], 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(frame.bh[c] * 8, frame.bw[c] * 8)[: frame.ch[c], : frame.cw[c]]
        up = _upsample(plane, frame.hmax // frame.h[c], frame.vmax // frame.v[c])
        planes.append(up[: frame.height, : frame.width])
    if len(planes) == 1:
        image = np.repeat(planes[0].astype(np.uint8)[:, :, None], 3, axis=2)
    else:
        rgb = False
        if not jfif:
            if adobe_transform is not None:
                rgb = adobe_transform == 0
            else:
                rgb = frame.ids == [82, 71, 66]
        if rgb:
            image = np.stack(planes, -1).astype(np.uint8)
        else:
            image = _ycc_to_rgb(*planes)
    if apply_orientation and orientation in range(2, 9):
        image = _orient(image, orientation)
    return np.ascontiguousarray(image)


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of a JPEG (its SOF) or PNG (its IHDR), unrotated."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(PNG_SIGNATURE):
        width, height = struct.unpack_from(">II", data, 16)
        return int(width), int(height)
    for marker, a, _, _ in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            height, width = struct.unpack_from(">HH", data, a + 1)
            return int(width), int(height)
        if marker == 0xDA:
            break
    raise ValueError(f"{path}: no JPEG frame header or PNG IHDR found")


def exif_focal_35mm(path: str, width: int) -> Optional[float]:
    """Focal length in pixels from ``FocalLengthIn35mmFilm`` (0xA405) in the
    IFD0 of a JPEG's Exif block, as the JAX package's dataset tools read it
    through PIL's ``getexif()``: a camera's value in the Exif sub-IFD is not
    seen (None), and PNG files give None."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:2] != b"\xff\xd8":
            return None
        f35 = _app1_exif(data).get(0xA405)
    except (OSError, ValueError, struct.error):
        return None
    if f35:
        return float(f35) / 35.0 * width
    return None
