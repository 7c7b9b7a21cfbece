"""ctypes bindings to the port's host C++ library (``csrc/lfr_native.cc``).

Counterparts of lfr_tpu/solver/native.py for the functions the port calls:
the maximum-spanning-forest union-find and its match order
(:mod:`.tracks`), the stable counting argsort (:mod:`.buckets`) and the
MatchingFile codec (:mod:`lfr_tpu_torch.io.protos`).  The library is built
by g++ at first use (:mod:`lfr_tpu_torch.ops.host_build`); a failed build
raises.  Each function equals a numpy route bit for bit, and that route
stays as the plain version: ``use_native=False`` of ``build_tracks`` and of
the codec, ``np.argsort(kind="stable")`` for the argsort.  Indices are
checked here before they reach C++.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from ..ops import host_build


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check_range(a: np.ndarray, n: int, name: str) -> None:
    if a.ndim != 1 or (a.size and (a.min() < 0 or a.max() >= n)):
        raise ValueError(f"{name} must be 1-D with entries in [0, {n})")


def msf_union_find(
    order: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    node_image: np.ndarray,
    n_nodes: int,
) -> np.ndarray:
    """The forest's parent array (-1 for roots) over edges taken in
    ``order``; see ``tracks._msf``, its plain version."""
    order = np.ascontiguousarray(order, dtype=np.int64)
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    node_image = np.ascontiguousarray(node_image, dtype=np.int64)
    _check_range(order, src.shape[0], "order")
    _check_range(src, n_nodes, "src")
    _check_range(dst, n_nodes, "dst")
    if src.shape != dst.shape or node_image.shape != (n_nodes,):
        raise ValueError("src and dst must match, node_image must hold n_nodes entries")
    parent = np.full(n_nodes, -1, dtype=np.int64)
    host_build.library().lfr_msf_union_find(
        order.shape[0], _ptr(order), _ptr(src), _ptr(dst), n_nodes, _ptr(node_image), _ptr(parent)
    )
    return parent


def sort_matches_desc(
    sim: np.ndarray, src: np.ndarray, dst: np.ndarray, n_threads: int = 4
) -> np.ndarray:
    """Match order by (sim desc, src desc, dst desc, index desc): a parallel
    merge sort equal to ``np.lexsort((dst, src, sim))[::-1]``."""
    sim = np.ascontiguousarray(sim, dtype=np.float32)
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if not sim.ndim == 1 or sim.shape != src.shape or sim.shape != dst.shape:
        raise ValueError("sim, src and dst must be 1-D of one length")
    order = np.empty(sim.shape[0], dtype=np.int64)
    host_build.library().lfr_sort_matches_desc(
        sim.shape[0], _ptr(sim), _ptr(src), _ptr(dst), _ptr(order), n_threads
    )
    return order


def counting_argsort(vals: np.ndarray, n_vals: int) -> np.ndarray:
    """Stable argsort of integer keys in [0, n_vals): O(n + n_vals), equal
    to ``np.argsort(vals, kind="stable")``."""
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    _check_range(vals, n_vals, "keys")
    order = np.empty(vals.shape[0], dtype=np.int64)
    host_build.library().lfr_counting_argsort(vals.shape[0], _ptr(vals), int(n_vals), _ptr(order))
    return order


def decode_matching_file(data: bytes) -> List:
    """MatchingFile bytes -> list of PairMatches (``protos``' numpy route
    is the plain version)."""
    from ..io.protos import PairMatches

    lib = host_build.library()
    buf = np.frombuffer(data, dtype=np.uint8)
    counts3 = np.zeros(3, np.int64)
    c = counts3.ctypes.data
    if lib.lfr_matching_count(_ptr(buf), len(data), c, c + 8, c + 16) != 0:
        raise ValueError("malformed MatchingFile (native count pass)")
    n_pairs, n_matches, name_bytes = (int(v) for v in counts3)

    counts = np.zeros(n_pairs, np.int64)
    facts = np.zeros(2 * n_pairs, np.float32)
    name_offsets = np.zeros(2 * n_pairs + 1, np.int64)
    name_data = np.zeros(max(name_bytes, 1), np.uint8)
    matches = np.zeros((n_matches, 2), np.uint32)
    sims = np.zeros(n_matches, np.float32)
    disps = np.zeros((n_matches, 2, 3, 3, 2), np.float32)
    rc = lib.lfr_matching_fill(
        _ptr(buf), len(data), _ptr(counts), _ptr(facts), _ptr(name_offsets),
        _ptr(name_data), _ptr(matches), _ptr(sims), _ptr(disps),
    )
    if rc != 0:
        raise ValueError("malformed MatchingFile (native fill pass)")

    names = name_data.tobytes()
    out = []
    m0 = 0
    for k in range(n_pairs):
        n = int(counts[k])
        name1 = names[name_offsets[2 * k] : name_offsets[2 * k + 1]].decode("utf-8")
        name2 = names[name_offsets[2 * k + 1] : name_offsets[2 * k + 2]].decode("utf-8")
        rows = slice(m0, m0 + n)
        out.append(
            PairMatches(
                name1, float(facts[2 * k]), name2, float(facts[2 * k + 1]),
                matches[rows].copy(), sims[rows].copy(),
                disps[rows, 0].copy(), disps[rows, 1].copy(),
            )
        )
        m0 += n
    return out


def encode_matching_file(pairs: Sequence) -> bytes:
    """List of PairMatches -> MatchingFile bytes, equal to ``protos``'
    numpy route."""
    lib = host_build.library()
    n_pairs = len(pairs)
    counts = np.array([p.num_matches for p in pairs], np.int64)
    facts = np.array([[p.fact1, p.fact2] for p in pairs], np.float32).reshape(-1)
    raw_names = [s.encode("utf-8") for p in pairs for s in (p.image_name1, p.image_name2)]
    name_offsets = np.zeros(2 * n_pairs + 1, np.int64)
    name_offsets[1:] = np.cumsum([len(b) for b in raw_names])
    name_data = np.frombuffer(b"".join(raw_names) or b"\0", np.uint8)
    total = int(counts.sum())
    matches = np.zeros((total, 2), np.uint32)
    sims = np.zeros(total, np.float32)
    disps = np.zeros((total, 2, 9, 2), np.float32)
    m0 = 0
    for p in pairs:
        n = p.num_matches
        matches[m0 : m0 + n] = p.matches
        sims[m0 : m0 + n] = p.similarities
        disps[m0 : m0 + n, 0] = np.asarray(p.disp1, np.float32).reshape(n, 9, 2)
        disps[m0 : m0 + n, 1] = np.asarray(p.disp2, np.float32).reshape(n, 9, 2)
        m0 += n
    args = (_ptr(counts), _ptr(facts), _ptr(name_offsets))
    arrays = (_ptr(matches), _ptr(sims), _ptr(disps))
    size = lib.lfr_matching_encode_size(n_pairs, *args, *arrays)
    out = ctypes.create_string_buffer(max(int(size), 1))
    if lib.lfr_matching_encode(n_pairs, *args, _ptr(name_data), *arrays, ctypes.addressof(out)) != 0:
        raise ValueError("native MatchingFile encode failed")
    return out.raw[: int(size)]
