"""Match-graph construction: matching + two-view refinement over a pair list
(port of lfr_tpu/pipelines/match_graph.py).

For every pair in the match list: load and downscale both images, match
their descriptors, run the coarse-to-fine flow CNN, and write a
reference-compatible MatchingFile (in ``.part.N`` chunks every
``dump_interval`` pairs).  Matching and refinement stream across pairs in
fixed-size CNN batches (:mod:`.stream`); with ``skip_refinement`` the pairs
are only matched and their flow grids are zero.

    python -m lfr_tpu_torch.pipelines.match_graph --image_path DIR \\
        --match_list_file LIST --method_name sift --output_file OUT \\
        --checkpoint weights/panet_holdout.msgpack [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import os
import sys
import time
from typing import List, Optional

import numpy as np

from ..config import DEFAULT_BATCH_SIZE, DUMP_INTERVAL, MethodConfig, get_method
from ..device import resolve_device
from ..io import features as features_io
from ..io import images as images_io
from ..io import match_list as match_list_io
from ..io import protos
from ..ops import matchers
from ..utils.timing import Accum
from .refinement import TwoViewRefiner, prepare_image
from .stream import MatchRefineStream

#: Host bytes of decoded images kept for reuse: an exhaustive match list
#: revisits every image about n_images times.
LOAD_CACHE_BYTES = int(2e9)

#: Device bytes of prepared (padded, 2x-upsampled) images kept for reuse;
#: a prepared image is read only when the stream (re)writes a stack slot.
PREP_CACHE_BYTES = int(2e9)


def compute_match_graph(
    image_path: str,
    match_list_file: str,
    method: MethodConfig,
    output_file: str,
    refiner: Optional[TwoViewRefiner] = None,
    skip_refinement: bool = False,
    dump_interval: int = DUMP_INTERVAL,
    progress: bool = True,
    sub_spans: Optional[dict] = None,
    device="cuda",
) -> List[str]:
    """Build the match graph for all pairs; returns the written file list.

    ``refiner`` is required unless ``skip_refinement`` (the reference's
    SKIP_REFINEMENT debug path: matches with zero flow grids); the port has
    no randomly initialised network.  Matching runs on ``refiner.device``,
    or on ``device`` when there is no refiner.  ``sub_spans``: optional dict
    filled with the stage's blocking-time breakdown (host decode, device
    uploads, matcher and CNN batches, proto emission) and the count of
    refined matches.
    """
    if refiner is None and not skip_refinement:
        raise ValueError(
            "a TwoViewRefiner is required: load PANet weights with "
            "models.checkpoint.load_variables, or pass skip_refinement=True"
        )
    dev = refiner.device if refiner is not None else resolve_device(device)
    accum = Accum()
    pairs = match_list_io.read_match_list(match_list_file)

    written: List[str] = []
    out_pairs: List[protos.PairMatches] = []
    part_idx = -1
    cached_name1 = None
    image1 = None
    fact1 = 1.0
    feats1 = None
    t0 = time.time()

    def _load(name):
        image, fact = images_io.load_and_downscale(
            os.path.join(image_path, name), method.max_edge, method.max_sum_edges
        )
        feats = features_io.load_features(os.path.join(image_path, name), method.name)
        return image, fact, feats

    # Host decode cache, byte-budgeted LRU.
    loaded = collections.OrderedDict()  # name -> (image, fact, feats)
    load_bytes = [0]

    def _remember(name, item):
        loaded[name] = item
        load_bytes[0] += item[0].nbytes
        while load_bytes[0] > LOAD_CACHE_BYTES and len(loaded) > 2:
            _, old = loaded.popitem(last=False)
            load_bytes[0] -= old[0].nbytes

    # Decode and feature IO of the next pair's second image overlap the
    # current pair's device work.
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    prefetched = {}

    def _get(name):
        hit = loaded.get(name)
        if hit is not None:
            loaded.move_to_end(name)
            prefetched.pop(name, None)
            return hit
        with accum.span("host_decode"):
            fut = prefetched.pop(name, None)
            item = fut.result() if fut is not None else _load(name)
        _remember(name, item)
        return item

    def _flush(final: bool) -> None:
        nonlocal part_idx, out_pairs
        with accum.span("proto_write"):
            if final and part_idx == -1:
                path = output_file
            else:
                part_idx += 1
                path = f"{output_file}.part.{part_idx}"
            protos.write_matching_file(path, out_pairs)
            written.append(path)
            out_pairs = []

    # Device cache of prepared images, each padded and pyramided once and
    # reused across its pairs (LRU-bounded).
    prepared = collections.OrderedDict()
    prep_bytes = [0]

    def _prep_size(p):
        return (p.base.array.numel() + p.up.array.numel()) * p.base.array.element_size()

    def _prep(name, image):
        p = prepared.get(name)
        if p is None:
            with accum.span("image_prep"):
                p = prepare_image(image, dev)
            prepared[name] = p
            prep_bytes[0] += _prep_size(p)
            while prep_bytes[0] > PREP_CACHE_BYTES and len(prepared) > 2:
                _, old = prepared.popitem(last=False)
                prep_bytes[0] -= _prep_size(old)
        else:
            prepared.move_to_end(name)
        return p

    def _emit(meta, payload):
        name1, fact1, name2, fact2 = meta
        m, sim, grid12, grid21 = payload
        # disp1 carries the flow toward image 1 (2->1 grids), disp2 toward
        # image 2 (reference: compute_match_graph.py:178-187).
        with accum.span("proto_emit"):
            out_pairs.append(
                protos.PairMatches(
                    name1, float(fact1), name2, float(fact2),
                    m.astype(np.uint32), sim.astype(np.float32),
                    disp1=grid21, disp2=grid12,
                )
            )

    stream = None if skip_refinement else MatchRefineStream(refiner, accum=accum)

    def _emit_stream(finish: bool) -> None:
        for smeta, payload in stream.flush() if finish else stream.ready():
            _emit(smeta, payload)

    try:
        for pair_idx, (name1, name2) in enumerate(pairs):
            if name1 != cached_name1:
                cached_name1 = name1
                image1, fact1, feats1 = _get(name1)
            image2, fact2, feats2 = _get(name2)
            if pair_idx + 1 < len(pairs):
                nxt = pairs[pair_idx + 1][1]
                if nxt not in prefetched and nxt not in loaded:
                    prefetched[nxt] = pool.submit(_load, nxt)

            meta = (name1, fact1, name2, fact2)
            if feats1.num_features > 0 and feats2.num_features > 0:
                # Keypoints live at original resolution; bring them to the
                # matching resolution (reference: compute_match_graph.py:127-131).
                kps1 = feats1.xy / fact1
                kps2 = feats2.xy / fact2
                if stream is not None:
                    stream.add_pair(
                        meta,
                        name1, _prep(name1, image1), kps1, feats1.descriptors,
                        name2, _prep(name2, image2), kps2, feats2.descriptors,
                        method.matcher, method.threshold,
                    )
                    _emit_stream(finish=False)
                else:
                    with accum.span("match"):
                        m, sim = matchers.match(
                            feats1.descriptors, feats2.descriptors,
                            method.matcher, method.threshold, device=dev,
                        )
                    z = np.zeros((m.shape[0], 3, 3, 2), dtype=np.float32)
                    _emit(meta, (m, sim, z, z))
            elif stream is not None:
                stream.add_empty_pair(meta)
            else:
                z = np.zeros((0, 3, 3, 2), dtype=np.float32)
                _emit(meta, (np.zeros((0, 2), np.int64), np.zeros(0, np.float32), z, z))

            if progress and (pair_idx + 1) % 25 == 0:
                rate = (pair_idx + 1) / (time.time() - t0)
                print(
                    f"[match-graph] {pair_idx + 1}/{len(pairs)} pairs ({rate:.2f} pairs/s)",
                    file=sys.stderr, flush=True,
                )
            if pair_idx % dump_interval == dump_interval - 1:
                if stream is not None:
                    _emit_stream(finish=True)
                _flush(final=False)

        if stream is not None:
            _emit_stream(finish=True)
        _flush(final=part_idx == -1)
    finally:
        if stream is not None:
            stream.close()
        pool.shutdown(wait=True, cancel_futures=True)
    accum.add("stage_total", time.time() - t0)
    if sub_spans is not None:
        sub_spans.update(accum.report())
        if stream is not None:
            sub_spans["n_refined_matches"] = int(stream.refined_rows)
    if progress:
        print(f"[match-graph] breakdown: {accum.report()}", file=sys.stderr)
    return written


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="match graph + two-view refinement")
    parser.add_argument("--image_path", required=True)
    parser.add_argument("--match_list_file", required=True)
    parser.add_argument("--method_name", required=True)
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--batch_size", type=int, default=DEFAULT_BATCH_SIZE)
    parser.add_argument(
        "--checkpoint", default=None,
        help="PANet weights as msgpack (weights/panet_*.msgpack); required "
        "unless SKIP_REFINEMENT is set",
    )
    parser.add_argument("--max_edge", type=int, default=None)
    parser.add_argument("--max_sum_edges", type=int, default=None)
    parser.add_argument("--matcher", default=None, choices=["similarity", "ratio"])
    parser.add_argument(
        "--fine_mode", default="crop", choices=["grid", "crop"],
        help="fine-pass formulation: 'crop' (backbone once per 65px crop; "
        "default) or 'grid' (reference-parity 9-patch grid)",
    )
    parser.add_argument("--threshold", type=float, default=None)
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="'cuda' (default; fails without a card) or 'cpu' (plain PyTorch versions)",
    )
    args = parser.parse_args(argv)

    method = get_method(args.method_name)
    # CLI overrides for custom methods.
    overrides = {
        k: v
        for k, v in dict(
            max_edge=args.max_edge, max_sum_edges=args.max_sum_edges,
            matcher=args.matcher, threshold=args.threshold,
        ).items()
        if v is not None
    }
    if overrides:
        method = dataclasses.replace(method, **overrides)

    skip = "SKIP_REFINEMENT" in os.environ
    refiner = None
    if not skip:
        if not args.checkpoint:
            parser.error("--checkpoint is required (or set SKIP_REFINEMENT)")
        from ..models.checkpoint import load_variables

        refiner = TwoViewRefiner(
            load_variables(args.checkpoint), batch_size=args.batch_size,
            fine_mode=args.fine_mode, device=args.device,
        )

    compute_match_graph(
        args.image_path, args.match_list_file, method, args.output_file,
        refiner=refiner, skip_refinement=skip, device=args.device,
    )


if __name__ == "__main__":
    main()
