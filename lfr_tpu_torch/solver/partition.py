"""Track meta-graph partitioning (host, numpy and scipy).

Port of lfr_tpu/solver/partition.py.  Builds the meta-graph over tracks
(inter-track edge weight = summed similarity), finds its connected
components, and recursively bisects any component whose node count exceeds
the cap (default: number of images) by a normalized min cut, dropping the
cut edges (reference: multi-view-refinement/solve.cc:162-373,586).

The cut is spectral: the Fiedler vector of the weighted normalized
Laplacian, swept for the threshold minimizing the normalized-cut objective.
It makes the same scipy calls as the JAX package, so the same graph gets the
same labels.
"""

from __future__ import annotations

import sys

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import scipy.sparse.linalg  # noqa: F401  (sp.linalg.eigsh)

from ..config import CUT_WEIGHT_SCALE
from .graph import PatchGraph
from .tracks import Tracks

#: Health counters of the most recent partition_components() call.  The
#: spectral fallback replaces a failed Fiedler solve with a degree-sorted
#: balanced halving; it is counted and logged, never silent.
partition_stats = {"spectral_fallbacks": 0, "cuts": 0}

#: Below this many nodes the Fiedler vector comes from a dense eigh.
_DENSE_EIGH_NODES = 32


def _normalized_cut_bisect(
    edges: np.ndarray, weights: np.ndarray, n: int, rng: np.random.Generator
) -> np.ndarray:
    """Bisect a connected weighted graph (local node ids 0..n-1).

    Returns (n,) labels in {0, 1} minimizing the swept normalized cut over
    the Fiedler ordering.
    """
    if n <= 1:
        return np.zeros(n, dtype=np.int64)
    w = sp.coo_matrix(
        (
            np.concatenate([weights, weights]).astype(np.float64),
            (
                np.concatenate([edges[:, 0], edges[:, 1]]),
                np.concatenate([edges[:, 1], edges[:, 0]]),
            ),
        ),
        shape=(n, n),
    ).tocsr()
    deg = np.maximum(np.asarray(w.sum(axis=1)).ravel(), 1e-12)

    d_inv_sqrt = 1.0 / np.sqrt(deg)
    lap = sp.eye(n) - sp.diags(d_inv_sqrt) @ w @ sp.diags(d_inv_sqrt)
    try:
        if n < _DENSE_EIGH_NODES:
            _, vecs = np.linalg.eigh(lap.toarray())
            fiedler = vecs[:, 1]
        else:
            vals, vecs = sp.linalg.eigsh(
                lap, k=2, sigma=-1e-6, which="LM", v0=rng.standard_normal(n)
            )
            fiedler = vecs[:, np.argsort(vals)[1]]
    except (np.linalg.LinAlgError, RuntimeError, ValueError) as exc:
        # ARPACK's and LAPACK's failures; fall back to a balanced split.
        partition_stats["spectral_fallbacks"] += 1
        print(
            f"[partition] spectral bisection failed on a {n}-node component "
            f"({type(exc).__name__}); using degree-sorted balanced halving",
            file=sys.stderr,
        )
        order = np.argsort(-deg)
        labels = np.zeros(n, dtype=np.int64)
        labels[order[: n // 2]] = 1
        return labels

    order = np.argsort(fiedler / np.sqrt(deg))
    # Sweep: an edge crosses the prefix-k cut iff lo < k <= hi in rank.
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    r1 = pos[edges[:, 0]]
    r2 = pos[edges[:, 1]]
    lo = np.minimum(r1, r2)
    hi = np.maximum(r1, r2)
    cut = np.zeros(n + 1)
    np.add.at(cut, lo + 1, weights.astype(np.float64))
    np.add.at(cut, hi + 1, -weights.astype(np.float64))
    cut = np.cumsum(cut)[1:n]  # cut size for prefixes k=1..n-1
    vol_a = np.cumsum(deg[order])[: n - 1]
    vol_b = deg.sum() - vol_a
    ncut = cut * (1.0 / np.maximum(vol_a, 1e-12) + 1.0 / np.maximum(vol_b, 1e-12))
    k = int(np.argmin(ncut)) + 1
    labels = np.zeros(n, dtype=np.int64)
    labels[order[:k]] = 1
    return labels


def _recursive_cut(
    edges: np.ndarray,
    weights: np.ndarray,
    node_weights: np.ndarray,
    node_ids: np.ndarray,
    max_weight: int,
    rng: np.random.Generator,
    out_labels: np.ndarray,
    next_label: int,
) -> int:
    """Bisect until every subset's node-weight sum <= max_weight
    (reference: solve.cc:185-250).  Returns the next free label."""
    n = node_ids.shape[0]
    # node_ids is unique-sorted, so global -> local is a searchsorted.
    le = np.searchsorted(node_ids, edges.reshape(-1)).reshape(-1, 2)
    partition_stats["cuts"] += 1
    labels = _normalized_cut_bisect(le, weights, n, rng)

    for side in (0, 1):
        ids = node_ids[labels == side]
        if ids.size == 0:
            continue
        if node_weights[ids].sum() <= max_weight or ids.size == 1:
            out_labels[ids] = next_label
            next_label += 1
            continue
        # Keep only intra-side edges and recurse (cross edges dropped).
        e_mask = (labels[le[:, 0]] == side) & (labels[le[:, 1]] == side)
        sub_edges = edges[e_mask]
        sub_weights = weights[e_mask]
        if sub_edges.shape[0] == 0:
            # No internal edges: every node becomes its own component
            # (reference: solve.cc:355-364 re-derives components by BFS).
            out_labels[ids] = next_label + np.arange(ids.size)
            next_label += ids.size
            continue
        # Nodes with edges recurse; isolated ones get singleton labels.
        touched = np.unique(sub_edges)
        untouched = np.setdiff1d(ids, touched)
        next_label = _recursive_cut(
            sub_edges, sub_weights, node_weights, touched, max_weight, rng, out_labels,
            next_label,
        )
        out_labels[untouched] = next_label + np.arange(untouched.size)
        next_label += untouched.size
    return next_label


def partition_components(
    graph: PatchGraph, tracks: Tracks, max_nodes_in_component: int = None
) -> np.ndarray:
    """Per-node component ids with bounded component sizes.

    The cap defaults to the number of images (reference: solve.cc:586).
    """
    partition_stats["spectral_fallbacks"] = 0
    partition_stats["cuts"] = 0
    if graph.num_nodes == 0:
        return np.zeros(0, dtype=np.int64)
    if max_nodes_in_component is None:
        max_nodes_in_component = len(graph.image_names)

    n_tracks = tracks.num_tracks
    t_src = tracks.track_idx[graph.edge_src]
    t_dst = tracks.track_idx[graph.edge_dst]
    inter = t_src != t_dst
    nodes_per_track = np.bincount(tracks.track_idx, minlength=n_tracks)

    # Directed inter-track edges aggregate into undirected meta edges with
    # summed similarity; each direction contributes (solve.cc:267-329).
    a = np.minimum(t_src[inter], t_dst[inter])
    b = np.maximum(t_src[inter], t_dst[inter])
    if a.size:
        uniq, inv = np.unique(a * n_tracks + b, return_inverse=True)
        wsum = np.zeros(uniq.shape[0])
        np.add.at(wsum, inv, graph.edge_sim[inter].astype(np.float64))
        meta_a = (uniq // n_tracks).astype(np.int64)
        meta_b = (uniq % n_tracks).astype(np.int64)
    else:
        meta_a = np.zeros(0, dtype=np.int64)
        meta_b = np.zeros(0, dtype=np.int64)
        wsum = np.zeros(0)

    adj = sp.coo_matrix(
        (np.ones(meta_a.shape[0]), (meta_a, meta_b)), shape=(n_tracks, n_tracks)
    )
    n_comp, comp = csgraph.connected_components(adj, directed=False)

    rng = np.random.default_rng(0)
    comp_node_weight = np.zeros(n_comp, dtype=np.int64)
    np.add.at(comp_node_weight, comp, nodes_per_track)

    final = np.full(n_tracks, -1, dtype=np.int64)
    next_label = 0
    # Integer weights, scaled like the reference (solve.cc:329).
    int_w = np.maximum((CUT_WEIGHT_SCALE * wsum).astype(np.int64), 1)

    for c in range(n_comp):
        track_mask = comp == c
        if comp_node_weight[c] <= max_nodes_in_component:
            final[track_mask] = next_label
            next_label += 1
            continue
        e_mask = track_mask[meta_a]
        edges = np.stack([meta_a[e_mask], meta_b[e_mask]], axis=1)
        touched = np.unique(edges) if edges.size else np.zeros(0, dtype=np.int64)
        next_label = _recursive_cut(
            edges,
            int_w[e_mask].astype(np.float64),
            nodes_per_track,
            touched,
            max_nodes_in_component,
            rng,
            final,
            next_label,
        )
        # Tracks of the component with no meta edges become singletons.
        lonely = np.nonzero(track_mask & (final == -1))[0]
        final[lonely] = next_label + np.arange(lonely.size)
        next_label += lonely.size

    # Cut meta edges are dropped; re-derive connected components so labels
    # equal connectivity (reference: solve.cc:345-364).
    keep = final[meta_a] == final[meta_b]
    adj2 = sp.coo_matrix(
        (np.ones(int(keep.sum())), (meta_a[keep], meta_b[keep])),
        shape=(n_tracks, n_tracks),
    )
    _, comp_final = csgraph.connected_components(adj2, directed=False)
    return comp_final[tracks.track_idx]
