"""Track building: maximum-spanning-forest with image-disjointness (host).

Port of lfr_tpu/solver/tracks.py.  Union-find over match
edges sorted by similarity (descending); a merge is rejected when the two
trees already observe a common image, so a track holds at most one feature
per image (reference: solve.cc:67-77,488-541).  The anchor of each track
follows solve.cc:551-582.  The sort and the union-find run in host C++
(``native``) unless ``use_native=False`` picks numpy's lexsort and
:func:`_msf`, their plain versions; the tracks are the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import native
from .graph import PatchGraph


@dataclasses.dataclass
class Tracks:
    track_idx: np.ndarray  # (N,) track id per node
    is_root: np.ndarray    # (N,) bool anchor mask
    num_tracks: int
    max_track_size: int


def _msf(
    order: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    node_image: np.ndarray,
    n_nodes: int,
) -> np.ndarray:
    """Returns the parent array (-1 for roots)."""
    parent = [-1] * n_nodes
    images_in_tree = [{img} for img in node_image.tolist()]
    src = src.tolist()
    dst = dst.tolist()

    def find(i: int) -> int:
        root = i
        while parent[root] != -1:
            root = parent[root]
        while parent[i] != -1:  # path compression
            parent[i], i = root, parent[i]
        return root

    for e in order.tolist():
        r1 = find(src[e])
        r2 = find(dst[e])
        if r1 == r2:
            continue
        s1 = images_in_tree[r1]
        s2 = images_in_tree[r2]
        # Two features of one image may not share a track (solve.cc:507-511).
        if not s1.isdisjoint(s2):
            continue
        # Smaller tree merges into larger (solve.cc:512-521).
        if len(s1) < len(s2):
            r1, r2 = r2, r1
            s1, s2 = s2, s1
        parent[r2] = r1
        s1.update(s2)
        images_in_tree[r2] = set()
    return np.asarray(parent, dtype=np.int64)


def build_tracks(graph: PatchGraph, use_native: bool = True) -> Tracks:
    n = graph.num_nodes
    if n == 0:
        return Tracks(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool), 0, 0)

    # Matches by similarity descending; ties broken like the C++ (sim, src,
    # dst) tuple sort: larger src, then larger dst first.
    src, dst, sim = graph.match_src, graph.match_dst, graph.match_sim
    if use_native:
        order = native.sort_matches_desc(sim, src, dst)
        parent = native.msf_union_find(order, src, dst, graph.node_image, n)
    else:
        order = np.lexsort((dst, src, sim))[::-1]
        parent = _msf(order, src, dst, graph.node_image, n)

    # Track ids from roots, in node order (solve.cc:526-541); every node is
    # resolved to its root by pointer jumping.
    roots_mask = parent == -1
    n_tracks = int(roots_mask.sum())
    track_of_root = np.full(n, -1, dtype=np.int64)
    track_of_root[roots_mask] = np.arange(n_tracks)
    resolved = parent.copy()
    resolved[roots_mask] = np.nonzero(roots_mask)[0]
    while True:
        grand = np.where(parent[resolved] == -1, resolved, parent[resolved])
        if np.array_equal(grand, resolved):
            break
        resolved = grand
    track_idx = track_of_root[resolved]

    sizes = np.bincount(track_idx, minlength=n_tracks)
    max_track = int(sizes.max()) if n_tracks else 0

    # Anchor: per node, score = sum of intra-track out-edge sims; the
    # highest-scored node of each track, ties to the larger node index, is
    # the frozen root (solve.cc:551-582).
    intra = track_idx[graph.edge_src] == track_idx[graph.edge_dst]
    scores = np.bincount(
        graph.edge_src[intra],
        weights=graph.edge_sim[intra].astype(np.float64),
        minlength=n,
    )
    order = np.lexsort((np.arange(n), scores))[::-1]
    is_root = np.zeros(n, dtype=bool)
    _, first_idx = np.unique(track_idx[order], return_index=True)
    is_root[order[first_idx]] = True

    return Tracks(track_idx, is_root, n_tracks, max_track)
