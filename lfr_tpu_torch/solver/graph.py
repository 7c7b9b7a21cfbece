"""Patch-graph construction from two-view matches (host, numpy).

Port of lfr_tpu/solver/graph.py on its numpy routes: flat edge arrays plus
per-node metadata, built with bulk operations.

Edge convention (reference: solve.cc:453-479): for a match between
(image1, feat1) and (image2, feat2), the edge 1->2 carries the flow toward
image 2 (``disp2``) and the edge 2->1 carries ``disp1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..io.protos import PairMatches


@dataclasses.dataclass
class PatchGraph:
    """Flat patch graph.

    Nodes are (image, feature) pairs.  ``edge_*`` arrays hold *directed*
    edges (two per match).  ``match_*`` arrays hold one entry per match
    (undirected), used by track building.
    """

    image_names: List[str]                 # image table
    image_facts: np.ndarray                # (I,) downscale factor per image
    node_image: np.ndarray                 # (N,) image idx per node
    node_feature: np.ndarray               # (N,) feature idx per node

    edge_src: np.ndarray                   # (E,) directed
    edge_dst: np.ndarray                   # (E,)
    edge_sim: np.ndarray                   # (E,)
    edge_flow: np.ndarray                  # (E, 3, 3, 2) flow toward dst

    match_src: np.ndarray                  # (M,) undirected (match) endpoints
    match_dst: np.ndarray                  # (M,)
    match_sim: np.ndarray                  # (M,)

    @property
    def num_nodes(self) -> int:
        return self.node_image.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_src.shape[0]


#: Largest (images x feature span) table interned densely; above it the
#: sort-based unique runs.
_DENSE_TABLE_MAX = 64_000_000


def _intern(keys: np.ndarray, table_size: int) -> np.ndarray:
    """Node id per key: rank of the key's first occurrence (first-seen order)."""
    if table_size <= _DENSE_TABLE_MAX:
        # Reverse-order scatter leaves the FIRST occurrence index in the table.
        first = np.full(table_size, -1, dtype=np.int64)
        rev_keys = np.ascontiguousarray(keys[::-1])
        first[rev_keys] = np.arange(keys.shape[0] - 1, -1, -1, dtype=np.int64)
        uniq_keys = np.flatnonzero(first >= 0)
        order = np.argsort(first[uniq_keys], kind="stable")
        rank_table = np.full(table_size, -1, dtype=np.int64)
        rank_table[uniq_keys[order]] = np.arange(uniq_keys.shape[0], dtype=np.int64)
        return rank_table[keys]
    _, first_pos, inverse = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first_pos, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return rank[inverse]


def build_graph(
    pairs: Sequence[PairMatches], banned_images: Optional[Set[str]] = None
) -> PatchGraph:
    """Build the patch graph from decoded image pairs.

    ``banned_images`` drops any pair touching those images
    (reference: solve.cc:403,444-446).
    """
    banned = banned_images or set()

    image_ids: Dict[str, int] = {}
    image_facts: List[float] = []

    def image_id(name: str, fact: float) -> int:
        if name not in image_ids:
            image_ids[name] = len(image_ids)
            image_facts.append(fact)
        return image_ids[name]

    per_pair = []
    for pair in pairs:
        if pair.image_name1 in banned or pair.image_name2 in banned:
            continue
        i1 = image_id(pair.image_name1, pair.fact1)
        i2 = image_id(pair.image_name2, pair.fact2)
        if pair.num_matches:
            per_pair.append((i1, i2, pair))

    facts = np.asarray(image_facts, dtype=np.float32)
    if not per_pair:
        z = np.zeros(0, dtype=np.int64)
        zf = np.zeros(0, dtype=np.float32)
        return PatchGraph(list(image_ids), facts, z, z, z, z, zf,
                          np.zeros((0, 3, 3, 2), dtype=np.float32), z, z, zf)

    counts = np.asarray([p.num_matches for _, _, p in per_pair], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(2 * counts)])
    moffsets = np.concatenate([[0], np.cumsum(counts)])
    n_match = int(counts.sum())
    n_edge = 2 * n_match

    # Endpoints in block layout per pair: [side1 x c, side2 x c].
    all_img = np.empty(n_edge, dtype=np.int64)
    all_feat = np.empty(n_edge, dtype=np.int64)
    edge_flow = np.empty((n_edge, 3, 3, 2), np.float32)
    for k, (i1, i2, pair) in enumerate(per_pair):
        b, c = int(offsets[k]), int(counts[k])
        m = pair.matches
        all_img[b : b + c] = i1
        all_img[b + c : b + 2 * c] = i2
        all_feat[b : b + c] = m[:, 0]
        all_feat[b + c : b + 2 * c] = m[:, 1]
        edge_flow[b : b + c] = pair.disp2
        edge_flow[b + c : b + 2 * c] = pair.disp1

    feat_span = int(all_feat.max()) + 1
    node_of_endpoint = _intern(all_img * feat_span + all_feat, len(image_ids) * feat_span)
    n_nodes = int(node_of_endpoint.max()) + 1
    node_image = np.zeros(n_nodes, dtype=np.int64)
    node_feature = np.zeros(n_nodes, dtype=np.int64)
    node_image[node_of_endpoint] = all_img
    node_feature[node_of_endpoint] = all_feat

    # The directed edge layout is [pair0 fwd, pair0 bwd, pair1 fwd, ...], so
    # ``edge_src`` IS the endpoint array and every other column swaps the two
    # halves of each pair block.
    edge_src = node_of_endpoint
    edge_dst = np.empty(n_edge, np.int64)
    edge_sim = np.empty(n_edge, np.float32)
    match_src = np.empty(n_match, np.int64)
    match_dst = np.empty(n_match, np.int64)
    match_sim = np.empty(n_match, np.float32)
    for k, (_, _, pair) in enumerate(per_pair):
        b, c, mb = int(offsets[k]), int(counts[k]), int(moffsets[k])
        s1 = edge_src[b : b + c]
        s2 = edge_src[b + c : b + 2 * c]
        sims = pair.similarities
        edge_dst[b : b + c] = s2
        edge_dst[b + c : b + 2 * c] = s1
        edge_sim[b : b + c] = sims
        edge_sim[b + c : b + 2 * c] = sims
        match_src[mb : mb + c] = s1
        match_dst[mb : mb + c] = s2
        match_sim[mb : mb + c] = sims

    return PatchGraph(
        image_names=list(image_ids),
        image_facts=facts,
        node_image=node_image,
        node_feature=node_feature,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_sim=edge_sim,
        edge_flow=edge_flow,
        match_src=match_src,
        match_dst=match_dst,
        match_sim=match_sim,
    )
