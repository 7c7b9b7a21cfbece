"""Feature and match import into a COLMAP database, with geometric
verification (port of lfr_tpu/pipelines/import_features.py).

Applies the multi-view solution to the keypoints (displacement units -> px,
times the image's downscale factor, plus COLMAP's 0.5 pixel-centre offset),
writes keypoints and putative matches, and verifies every pair with the
batched F + H RANSAC of :mod:`lfr_tpu_torch.sfm.verify` on the device.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import DISPLACEMENT_UNIT_PX
from ..io import colmap_db as db_mod
from ..io import features as features_io
from ..io import protos
from ..sfm import verify
from ..utils import timing


def apply_solution(
    keypoints: np.ndarray,
    solution: Optional[protos.ImageSolution],
) -> np.ndarray:
    """Shift keypoints by the solved displacements.

    Displacement (di, dj) maps to (dx, dy) = (dj, di), scaled back to the
    original resolution by ``fact`` and to pixels by the 16-px unit
    (reference: colmap_utils.py:104-137).
    """
    out = keypoints.copy()
    if solution is not None:
        disp = np.zeros((keypoints.shape[0], 2), dtype=np.float32)
        idx = solution.feature_indices
        disp[idx, 0] = solution.displacements[:, 1]  # dj -> dx
        disp[idx, 1] = solution.displacements[:, 0]  # di -> dy
        out[:, :2] += disp * solution.fact * DISPLACEMENT_UNIT_PX
    # COLMAP's upper-left pixel center is (0.5, 0.5).
    out[:, :2] += 0.5
    return out


def import_features(
    method_name: str,
    database_path: str,
    image_path: str,
    matches_file: str,
    solution_file: Optional[str] = None,
    verify_seed: int = 0,
    min_num_inliers: int = verify.MIN_NUM_INLIERS,
    verbose: bool = True,
    device="cuda",
    spans: Optional[timing.Spans] = None,
) -> dict:
    """Import features + matches, verify geometry, return matching stats
    (those of the JAX package, plus ``num_putative_pairs`` and the
    verifier's ``verify_batches``).  ``spans`` receives ``keypoints``,
    ``matches`` and ``verify``."""
    verifier = verify.BatchedVerifier(
        seed=verify_seed, min_num_inliers=min_num_inliers, device=device
    )
    solutions: Dict[str, protos.ImageSolution] = {}
    if solution_file is not None:
        for sol in protos.read_solution_file(solution_file):
            solutions[sol.image_name] = sol

    spans = timing.Spans() if spans is None else spans
    db = db_mod.ColmapDatabase(database_path)
    db.clear_features_and_matches()
    images = db.image_ids()

    sum_num_features = 0
    all_keypoints: Dict[int, np.ndarray] = {}
    with spans.span("keypoints"):
        for image_name, image_id in images.items():
            feats = features_io.load_features(
                os.path.join(image_path, image_name), method_name
            )
            keypoints = feats.completed_keypoints().astype(np.float32)
            if keypoints.shape[0] == 0:
                keypoints = np.zeros((0, 4), np.float32)
            keypoints = apply_solution(keypoints, solutions.get(image_name))
            sum_num_features += keypoints.shape[0]
            db.set_keypoints(image_id, keypoints)
            all_keypoints[image_id] = keypoints
        db.commit()

    # Putative matches (dedup by pair id, reference: colmap_utils.py:159-191).
    with spans.span("matches"):
        pairs = protos.read_matching_file(matches_file)
        seen = set()
        put_pairs: List[Tuple[int, int, np.ndarray]] = []
        for pair in pairs:
            if pair.image_name1 not in images or pair.image_name2 not in images:
                continue
            id1 = images[pair.image_name1]
            id2 = images[pair.image_name2]
            pid = db_mod.pair_id_from_image_ids(id1, id2)
            if pid in seen:
                continue
            seen.add(pid)
            m = pair.matches.astype(np.uint32)
            db.set_matches(id1, id2, m)
            put_pairs.append((id1, id2, m))
        db.commit()

    # Geometric verification (replaces `colmap matches_importer`): device
    # batches, one in flight while the host writes the previous results.
    n_done = 0

    def _write(results) -> None:
        nonlocal n_done
        for (id1, id2), tvg in results:
            db.set_two_view_geometry(
                id1, id2, tvg.inlier_matches, tvg.config, F=tvg.F, H=tvg.H
            )
            n_done += 1
            if verbose and n_done % 200 == 0:
                print(f"[verify] {n_done}/{len(put_pairs)} pairs", file=sys.stderr, flush=True)

    with spans.span("verify"):
        for id1, id2, m in put_pairs:
            verifier.add((id1, id2), all_keypoints[id1], all_keypoints[id2], m.astype(np.int64))
            _write(verifier.ready())
        _write(verifier.flush())
        db.commit()

    stats = db.matching_stats()
    stats["avg_num_features"] = sum_num_features / max(stats["num_images"], 1)
    stats["num_putative_pairs"] = len(put_pairs)
    stats["verify_batches"] = verifier.counters["batches"]
    stats["timing"] = spans.report()
    db.close()
    return stats
