"""Multi-view solve: MatchingFile -> refined displacements -> SolutionFile.

Port of lfr_tpu/solver/solve.py (reference: multi-view-refinement/
solve.cc:375-682).  The host builds the patch graph, the tracks and the
bounded components; the device solves the components as padded LM batches;
the result is written as a reference-compatible SolutionFile.  Prints the
same health counters as the reference.

    python -m lfr_tpu_torch.solver.solve --matches_file M --output_file S [--device cpu]

Two-phase budget: the LM of a batch runs until its slowest lane is done, so
every batch first runs ``INITIAL_LM_ITER`` steps; then only the lanes that
are not done run again, from the positions they reached, with the rest of
the budget (``lam`` and the cost start afresh, as in the JAX package).  The
straggler batch runs at its own size: lanes are independent.

Streaming: a worker thread packs batch k+1 while the device solves batch k,
and every batch's first phase is dispatched before any position is read
back.

Sharded route (``use_mesh``; by default when a process group of more than
one rank is initialised, as the JAX package shards when it sees more than
one device): every rank builds the same graph, tracks and components, and
each bucket is solved by ``parallel.sharded.sharded_lm`` over every rank at
``max_iter`` in one phase, with no stragglers (solve.py:95-100 of the JAX
package); rank 0 logs and writes the SolutionFile.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import time
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ..config import LM_MAX_ITERATIONS
from ..device import resolve_device
from ..io import protos
from ..utils.timing import Accum
from . import buckets as buckets_mod
from . import graph as graph_mod
from . import lm
from . import partition as partition_mod
from . import tracks as tracks_mod

#: Phase-1 LM budget: covers the p90 of convergence (median 4 / p90 9
#: iterations); lanes still running re-solve as a straggler batch.
INITIAL_LM_ITER = 16


def _next_timed(it):
    t0 = time.perf_counter()
    item = next(it, None)
    return item, time.perf_counter() - t0


def _solve_positions_sharded(graph, tracks, component_idx, max_iter, mesh, accum, counters):
    """(N, 2) f32 positions of every node, each bucket solved over the mesh."""
    from ..parallel.sharded import sharded_lm

    positions = np.zeros((graph.num_nodes, 2), dtype=np.float32)
    n_batches = iterations_max = lm_steps = 0
    packed = buckets_mod.iter_packed(graph, tracks, component_idx)
    while True:
        item, seconds = _next_timed(packed)
        accum.add("pack", seconds)
        if item is None:
            break
        batch, node_map = item
        with accum.span("lm_sharded"):
            solved, iterations, steps = sharded_lm(batch, mesh, max_iter)
        valid = node_map >= 0
        positions[node_map[valid]] = solved[valid]
        if valid.any():
            iterations_max = max(iterations_max, int(iterations[valid.any(axis=1)].max()))
        n_batches += 1
        lm_steps += steps
    counters.update(n_batches=n_batches, n_stragglers=0, iterations_max=iterations_max,
                    lm_steps=lm_steps, mesh_size=mesh.size)
    return positions


def _solve_positions(graph, tracks, component_idx, max_iter, dev, accum, counters):
    """(N, 2) f32 positions of every node; roots and singletons stay at 0."""
    positions = np.zeros((graph.num_nodes, 2), dtype=np.float32)
    initial_iter = min(INITIAL_LM_ITER, max_iter)
    packed = buckets_mod.iter_packed(graph, tracks, component_idx)
    pending = []
    with concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="lfr-pack") as pool:
        future = pool.submit(_next_timed, packed)
        while True:
            item, seconds = future.result()
            accum.add("pack", seconds)
            if item is None:
                break
            future = pool.submit(_next_timed, packed)
            batch, node_map = item
            with accum.span("lm_phase1"):
                arrays, free = lm.to_device(batch, dev)
                res = lm.lm_solve(arrays, free, max_iter=initial_iter)
            pending.append((res, arrays, free, node_map))

    n_stragglers = 0
    iterations_max = 0
    lm_steps = sum(res.steps for res, _, _, _ in pending)
    for res, arrays, free, node_map in pending:
        with accum.span("lm_stragglers"):
            done = res.done.cpu().numpy()
            iterations = res.iterations.cpu().numpy()
            x = res.x
            strag = np.nonzero(~done & (node_map >= 0).any(axis=1))[0]
            if strag.size and initial_iter < max_iter:
                n_stragglers += int(strag.size)
                lanes = torch.as_tensor(strag, device=dev)
                sub = lm.lm_solve(
                    lm.EdgeArrays(*(a[lanes] for a in arrays)), free[lanes],
                    x0=x[lanes], max_iter=max_iter - initial_iter,
                )
                lm_steps += sub.steps
                x = x.clone()
                x[lanes] = sub.x
                iterations[strag] += sub.iterations.cpu().numpy()
            solved = x.cpu().numpy()
        valid = node_map >= 0
        positions[node_map[valid]] = solved[valid]
        if valid.any():
            iterations_max = max(iterations_max, int(iterations[valid.any(axis=1)].max()))
    counters.update(n_batches=len(pending), n_stragglers=n_stragglers,
                    iterations_max=iterations_max, lm_steps=lm_steps)
    return positions


def _image_solutions(graph, positions) -> List[protos.ImageSolution]:
    """Images in first-seen node order, features in node order
    (reference: solve.cc:643-671)."""
    solutions: List[protos.ImageSolution] = []
    n_images = len(graph.image_names)
    if not graph.num_nodes:
        return solutions
    first_seen = np.full(n_images, graph.num_nodes, dtype=np.int64)
    np.minimum.at(first_seen, graph.node_image, np.arange(graph.num_nodes))
    node_order = np.argsort(graph.node_image, kind="stable")
    starts = np.searchsorted(graph.node_image[node_order], np.arange(n_images))
    ends = np.append(starts[1:], graph.num_nodes)
    for img in np.argsort(first_seen, kind="stable"):
        if first_seen[img] == graph.num_nodes:
            continue  # image present only in pairs without matches
        nodes = node_order[starts[img] : ends[img]]
        solutions.append(
            protos.ImageSolution(
                graph.image_names[img],
                float(graph.image_facts[img]),
                graph.node_feature[nodes].astype(np.uint32),
                positions[nodes],
            )
        )
    return solutions


def _solve(pairs, banned_images, max_iter, dev, log, accum, counters, mesh=None):
    if max_iter is None:
        max_iter = LM_MAX_ITERATIONS
    with accum.span("graph"):
        graph = graph_mod.build_graph(pairs, banned_images)
    log(f"# graph nodes: {graph.num_nodes}")
    log(f"# graph edges: {graph.num_edges}")

    t_start = time.perf_counter()
    with accum.span("tracks"):
        tracks = tracks_mod.build_tracks(graph)
    log(f"# tracks: {tracks.num_tracks}")
    log(f"max track size: {tracks.max_track_size}")

    t1 = time.perf_counter()
    with accum.span("partition"):
        component_idx = partition_mod.partition_components(graph, tracks)
    t2 = time.perf_counter()
    log(f"Graph-cut time: {int((t2 - t1) * 1000)}ms")
    n_components = int(component_idx.max()) + 1 if component_idx.size else 0
    log(f"# components: {n_components}")
    if n_components:
        log(f"max component size: {int(np.bincount(component_idx).max())}")

    t1 = time.perf_counter()
    if mesh is None:
        positions = _solve_positions(graph, tracks, component_idx, max_iter, dev, accum, counters)
    else:
        positions = _solve_positions_sharded(graph, tracks, component_idx, max_iter, mesh, accum,
                                             counters)
    t2 = time.perf_counter()
    accum.add("lm_wall", t2 - t1)
    if counters["n_stragglers"]:
        log(f"# straggler re-solves past {min(INITIAL_LM_ITER, max_iter)} iterations: "
            f"{counters['n_stragglers']}")
    log(f"Solver time: {int((t2 - t1) * 1000)}ms")
    log(f"Total time: {int((t2 - t_start) * 1000)}ms")

    n_outside = int((np.abs(positions) > 0.5).any(axis=1).sum())
    log(f"# points with at least one coordinate > 0.5: {n_outside}")
    counters.update(n_nodes=graph.num_nodes, n_edges=graph.num_edges,
                    n_components=n_components, n_outside=n_outside)
    return _image_solutions(graph, positions)


def _logger(verbose: bool):
    def log(msg):
        if verbose:
            print(msg, flush=True)

    return log


def _mesh(use_mesh: Optional[bool], device):
    """The mesh of the sharded route, or None: by default when a process
    group of more than one rank is initialised."""
    import torch.distributed as dist

    if use_mesh is None:
        use_mesh = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    if not use_mesh:
        return None
    from ..parallel.mesh import make_mesh

    return make_mesh(device=device)


def _report(sub_spans: Optional[Dict], accum: Accum, counters: Dict, t0: float) -> None:
    accum.add("stage_total", time.perf_counter() - t0)
    if sub_spans is not None:
        sub_spans.update(accum.report())
        sub_spans.update(counters)


def solve_matches(
    pairs: Sequence[protos.PairMatches],
    banned_images: Optional[Set[str]] = None,
    max_iter: Optional[int] = None,
    device="cuda",
    verbose: bool = True,
    sub_spans: Optional[Dict] = None,
    use_mesh: Optional[bool] = None,
) -> List[protos.ImageSolution]:
    """Full multi-view optimization over decoded match pairs.

    ``use_mesh``: solve every bucket over all ranks of the process group
    (``lfr_tpu_torch.parallel``); by default when a process group of more
    than one rank is initialised.  Every rank must call it on the same pairs.

    ``sub_spans``, when given, receives the seconds of each stage (``graph``,
    ``tracks``, ``partition``, ``pack`` (on the packing thread),
    ``lm_phase1``, ``lm_stragglers``, ``lm_wall`` (the wall clock from the
    first pack to the last read-back), ``stage_total``) and the counters
    ``n_nodes``, ``n_edges``, ``n_components``, ``n_batches``,
    ``n_stragglers``, ``iterations_max``, ``lm_steps`` (LM steps the batches
    ran, phase 1 and stragglers) and ``n_outside`` (nodes with a coordinate
    beyond 0.5); the sharded route has ``lm_sharded`` (this rank's LM and
    the gathers) for the LM spans, ``lm_steps`` of this rank, and
    ``mesh_size``.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    mesh = _mesh(use_mesh, device)
    accum, counters = Accum(), {}
    log = _logger(verbose and (mesh is None or mesh.rank == 0))
    solutions = _solve(pairs, banned_images, max_iter, dev, log, accum, counters, mesh)
    _report(sub_spans, accum, counters, t0)
    return solutions


def solve_file(
    matches_file: str,
    output_file: str,
    banned_images: Optional[Set[str]] = None,
    device="cuda",
    verbose: bool = True,
    sub_spans: Optional[Dict] = None,
    use_mesh: Optional[bool] = None,
) -> None:
    """:func:`solve_matches` from a MatchingFile (or its ``.part.N`` chunks)
    to a SolutionFile; ``sub_spans`` also gets ``read`` and ``write``.  On
    the sharded route every rank reads the file and rank 0 writes."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    mesh = _mesh(use_mesh, device)
    accum, counters = Accum(), {}
    with accum.span("read"):
        pairs = protos.read_matching_file(matches_file)
    log = _logger(verbose and (mesh is None or mesh.rank == 0))
    solutions = _solve(pairs, banned_images, None, dev, log, accum, counters, mesh)
    if mesh is None or mesh.rank == 0:
        with accum.span("write"):
            protos.write_solution_file(output_file, solutions)
    _report(sub_spans, accum, counters, t0)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="multi-view patch-graph solver")
    parser.add_argument("--matches_file", required=True)
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--banned_images", nargs="*", default=[])
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="'cuda' (default; fails without a card) or 'cpu'",
    )
    args = parser.parse_args(argv)
    solve_file(args.matches_file, args.output_file, set(args.banned_images), device=args.device)


if __name__ == "__main__":
    main()
