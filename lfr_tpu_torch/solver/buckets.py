"""Pack graph components into padded size buckets for the batched solver.

Port of lfr_tpu/solver/buckets.py on its numpy routes.  Components are
grouped by power-of-two node-count buckets, padded, and solved as dense
batches.  Packing is vectorized (flat segment gathers and 2-D scatters, no
per-component loop) and exposed as a generator (:func:`iter_packed`) so the
solve can pack batch k+1 while the device solves batch k.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

from .graph import PatchGraph
from .lm import ComponentBatch
from .tracks import Tracks


@dataclasses.dataclass
class PackedBuckets:
    batches: List[ComponentBatch]
    #: per batch: (B, N) global node index for scattering solutions back
    #: (-1 on padding).
    node_maps: List[np.ndarray]


def _next_pow2(x: int, floor: int = 2) -> int:
    n = floor
    while n < x:
        n *= 2
    return n


def _gather_segments(order, starts, ends, chunk):
    """Flatten the ``order[starts[c]:ends[c]]`` segments of all components
    in ``chunk``.  Returns (flat values, batch row per value, column per
    value)."""
    counts = ends[chunk] - starts[chunk]
    total = int(counts.sum())
    seg_off = np.repeat(starts[chunk], counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    rows = np.repeat(np.arange(len(chunk)), counts)
    return order[seg_off + within], rows, within


def iter_packed(
    graph: PatchGraph,
    tracks: Tracks,
    component_idx: np.ndarray,
    max_batch_elems: int = 1 << 24,
    max_batch_edges: int = 1 << 18,
) -> Iterator[Tuple[ComponentBatch, np.ndarray]]:
    """Yield (ComponentBatch, node_map) per padded bucket chunk.

    ``max_batch_elems`` caps B * (2N)^2 (dense normal equations) and
    ``max_batch_edges`` caps B * E (per-edge Jacobian temporaries) per
    batch, bounding the solver's peak device memory.
    """
    n_nodes = graph.num_nodes
    if n_nodes == 0:
        return

    n_comp = int(component_idx.max()) + 1
    comp_sizes = np.bincount(component_idx, minlength=n_comp)

    # Keep directed edges internal to a component (reference drops
    # cross-component edges, solve.cc:114-123).  The flow grids are read
    # straight from ``graph.edge_flow`` per chunk through composed indices.
    keep = component_idx[graph.edge_src] == component_idx[graph.edge_dst]
    kept = np.nonzero(keep)[0]
    all_flow = np.ascontiguousarray(graph.edge_flow, dtype=np.float32)
    esrc = graph.edge_src[kept]
    edst = graph.edge_dst[kept]
    esim = graph.edge_sim[kept]
    eintra = tracks.track_idx[esrc] == tracks.track_idx[edst]
    ecomp = component_idx[esrc]

    # Group nodes and edges by component.
    node_order = np.argsort(component_idx, kind="stable")
    node_starts = np.searchsorted(component_idx[node_order], np.arange(n_comp))
    node_ends = np.append(node_starts[1:], n_nodes)

    edge_order = np.argsort(ecomp, kind="stable")
    edge_starts = np.searchsorted(ecomp[edge_order], np.arange(n_comp))
    edge_ends = np.append(edge_starts[1:], esrc.shape[0])

    # Local node index within each component.
    pos_in_sorted = np.empty(n_nodes, dtype=np.int64)
    pos_in_sorted[node_order] = np.arange(n_nodes)
    local_idx = pos_in_sorted - node_starts[component_idx]
    local_src = local_idx[esrc].astype(np.int32)
    local_dst = local_idx[edst].astype(np.int32)

    # Bucket = next power of two of the component size; singletons skipped.
    nonsingleton = np.nonzero(comp_sizes > 1)[0]
    if nonsingleton.size == 0:
        return
    bucket_of = 1 << np.ceil(
        np.log2(np.maximum(comp_sizes[nonsingleton], 2))
    ).astype(np.int64)
    buckets: Dict[int, np.ndarray] = {
        int(bk): nonsingleton[bucket_of == bk] for bk in np.unique(bucket_of)
    }

    for n_bucket in sorted(buckets, reverse=True):
        comps = buckets[n_bucket]
        e_bucket = _next_pow2(int((edge_ends[comps] - edge_starts[comps]).max()))
        max_b = max(
            1,
            min(
                int(max_batch_elems // max((2 * n_bucket) ** 2, 1)),
                int(max_batch_edges // max(e_bucket, 1)),
            ),
        )
        for chunk_start in range(0, len(comps), max_b):
            chunk = comps[chunk_start : chunk_start + max_b]
            # Batch dim padded to a power of two (padding lanes are invalid
            # and skipped through the -1 node_map), as in the JAX package.
            b = 1 << max(2, int(len(chunk) - 1).bit_length())
            b_esrc = np.zeros((b, e_bucket), dtype=np.int32)
            b_edst = np.zeros((b, e_bucket), dtype=np.int32)
            b_esim = np.zeros((b, e_bucket), dtype=np.float32)
            b_eflow = np.zeros((b, e_bucket, 3, 3, 2), dtype=np.float32)
            b_eintra = np.zeros((b, e_bucket), dtype=bool)
            b_evalid = np.zeros((b, e_bucket), dtype=bool)
            b_root = np.zeros((b, n_bucket), dtype=bool)
            b_nvalid = np.zeros((b, n_bucket), dtype=bool)
            b_nodemap = np.full((b, n_bucket), -1, dtype=np.int64)

            nodes, rows, cols = _gather_segments(node_order, node_starts, node_ends, chunk)
            b_nodemap[rows, cols] = nodes
            b_nvalid[rows, cols] = True
            b_root[rows, cols] = tracks.is_root[nodes]

            eidx, erows, ecols = _gather_segments(edge_order, edge_starts, edge_ends, chunk)
            b_esrc[erows, ecols] = local_src[eidx]
            b_edst[erows, ecols] = local_dst[eidx]
            b_esim[erows, ecols] = esim[eidx]
            b_eflow[erows, ecols] = all_flow[kept[eidx]]
            b_eintra[erows, ecols] = eintra[eidx]
            b_evalid[erows, ecols] = True

            yield (
                ComponentBatch(
                    b_esrc, b_edst, b_esim, b_eflow, b_eintra, b_evalid, b_root, b_nvalid
                ),
                b_nodemap,
            )


def pack_components(
    graph: PatchGraph,
    tracks: Tracks,
    component_idx: np.ndarray,
    max_batch_elems: int = 1 << 24,
    max_batch_edges: int = 1 << 18,
) -> PackedBuckets:
    """Eager wrapper over :func:`iter_packed`."""
    batches: List[ComponentBatch] = []
    node_maps: List[np.ndarray] = []
    for batch, node_map in iter_packed(
        graph, tracks, component_idx, max_batch_elems, max_batch_edges
    ):
        batches.append(batch)
        node_maps.append(node_map)
    return PackedBuckets(batches, node_maps)
