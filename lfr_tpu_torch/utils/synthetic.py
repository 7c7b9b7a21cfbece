"""Synthetic images and keypoints for the port's tests and chip smoke run.

A numpy-only copy of ``textured_image``, ``shifted_pair`` and
``planted_features`` from lfr_tpu.utils.synthetic: the same seed gives the
same arrays in both packages.  :func:`bench_workload` is bench.py's
two-view workload, :func:`match_graph_workload` writes a scene of PNG
images and feature files for the match graph, and :func:`solver_graph`
is a match graph for the multi-view solver.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def textured_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth random texture with enough gradient structure for matching."""
    base = rng.random((h // 8 + 2, w // 8 + 2, 3))
    # Bilinear upsample to full size.
    yi = np.linspace(0, base.shape[0] - 1.001, h)
    xi = np.linspace(0, base.shape[1] - 1.001, w)
    y0 = yi.astype(int)
    x0 = xi.astype(int)
    fy = (yi - y0)[:, None, None]
    fx = (xi - x0)[None, :, None]
    img = (
        base[y0][:, x0] * (1 - fy) * (1 - fx)
        + base[y0][:, x0 + 1] * (1 - fy) * fx
        + base[y0 + 1][:, x0] * fy * (1 - fx)
        + base[y0 + 1][:, x0 + 1] * fy * fx
    )
    noise = rng.random((h, w, 3)) * 0.25
    img = (img * 0.75 + noise) * 255
    return img.astype(np.uint8)


def shifted_pair(
    rng: np.random.Generator, h: int = 240, w: int = 320, shift: Tuple[float, float] = (3.0, -2.0)
) -> Tuple[np.ndarray, np.ndarray]:
    """(image, image shifted by integer (di, dj)) — exact translation pair."""
    di, dj = int(shift[0]), int(shift[1])
    big = textured_image(rng, h + 2 * abs(di) + 8, w + 2 * abs(dj) + 8)
    o = abs(di) + 4, abs(dj) + 4
    img1 = big[o[0] : o[0] + h, o[1] : o[1] + w]
    img2 = big[o[0] + di : o[0] + di + h, o[1] + dj : o[1] + dj + w]
    return img1.copy(), img2.copy()


def planted_features(
    rng: np.random.Generator,
    n: int,
    h: int,
    w: int,
    dim: int = 128,
    margin: float = 24.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random keypoints (x, y) inside margins + unit-norm descriptors."""
    xy = np.stack(
        [
            rng.uniform(margin, w - margin, n),
            rng.uniform(margin, h - margin, n),
        ],
        axis=1,
    )
    desc = rng.standard_normal((n, dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return xy, desc


#: Matches per call in :func:`bench_workload`.
BENCH_MATCHES = 2048


def bench_workload(
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """bench.py's two-view workload: a 480x640 pair shifted by (3, -2) px and
    2048 exact matches (kps2 = kps1 + (2, -3) in (x, y)).

    Returns (image1, image2, kps1, kps2, matches)."""
    image1, image2 = shifted_pair(rng, 480, 640, (3, -2))
    kps1, _ = planted_features(rng, BENCH_MATCHES, 480, 640)
    kps2 = kps1 + np.array([2.0, -3.0])
    matches = np.stack([np.arange(BENCH_MATCHES), np.arange(BENCH_MATCHES)], axis=1)
    return image1, image2, kps1, kps2, matches


def match_graph_workload(
    rng: np.random.Generator,
    directory: str,
    num_views: int = 8,
    height: int = 1334,
    width: int = 2000,
    points_per_view: int = 4096,
) -> dict:
    """Write a match-graph scene into ``directory``: ``num_views`` PNG crops
    of one :func:`textured_image` canvas, at offsets that are multiples of
    5 px, each with a ``<image>.sift`` feature file, and an exhaustive match
    list.

    Each view holds ``points_per_view`` keypoints drawn from one pool of
    canvas points inside the area all views share (the pool is a third
    larger, so two views share about three quarters of their points).  A
    canvas point has one unit descriptor; each view adds Gaussian noise of
    0.02 per component and renormalises.  With the defaults the views
    are 1334x2000, which the ``sift`` method's caps (1600 / 3200) scale by
    1/1.25 to 1067x1600, and a 5 px offset becomes a 4 px shift.

    Returns {"images": names, "match_list": path, "point_ids": per view
    (N,) canvas point ids of its keypoints, "offsets": (V, 2) (y, x) px}.
    """
    from ..io import features as features_io
    from ..io import match_list as match_list_io
    from ..io.png import encode_png

    step, noise = 5, 0.02
    span = 8 * step
    canvas = textured_image(rng, height + span, width + span)
    offsets = rng.integers(0, 8, size=(num_views, 2)) * step
    pool = int(round(points_per_view * 4 / 3))
    margin = 24.0
    # Canvas (x, y) inside every view, with a margin.
    lo = offsets.max(axis=0)[::-1] + margin
    hi = offsets.min(axis=0)[::-1] + np.array([width, height]) - margin
    if (hi <= lo).any():
        raise ValueError(f"views of {height}x{width} share no area at offsets up to {span} px")
    points = rng.uniform(lo, hi, (pool, 2))
    descriptors = rng.standard_normal((pool, 128)).astype(np.float32)
    descriptors /= np.linalg.norm(descriptors, axis=1, keepdims=True)

    names, point_ids = [], []
    for v, (oy, ox) in enumerate(offsets):
        name = f"view{v:02d}.png"
        path = os.path.join(directory, name)
        with open(path, "wb") as fh:
            fh.write(encode_png(canvas[oy : oy + height, ox : ox + width]))
        ids = rng.choice(pool, points_per_view, replace=False)
        desc = descriptors[ids] + noise * rng.standard_normal((points_per_view, 128)).astype(
            np.float32
        )
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        features_io.save_features(
            path, points[ids] - np.array([ox, oy], np.float64), desc, method_name="sift"
        )
        names.append(name)
        point_ids.append(ids)
    match_list = os.path.join(directory, "match_list.txt")
    match_list_io.write_match_list(match_list, match_list_io.exhaustive_pairs(names))
    return {"images": names, "match_list": match_list, "point_ids": point_ids,
            "offsets": offsets}


def solver_graph(
    rng: np.random.Generator,
    n_images: int,
    n_points: int,
    visibility: float = 0.5,
    outlier_share: float = 0.0,
):
    """Pairwise matches over shared synthetic points with constant flows.

    Point p lies at ``offsets[image, p]`` (uniform in +-0.3 units) in each
    image that sees it (probability ``visibility``); feature p of every image
    is point p.  Each image pair matches its shared points with similarity
    uniform in [0.5, 1) and flow grids constant at the offset difference.
    With ``outlier_share == 0`` this is ``synth_match_graph`` of
    scripts/bench_solver.py, array for array.  Otherwise, after the clean
    graph, that share of each pair's matches (rounded) is rewired to a random
    feature of image 2, drawn from the same ``rng``; their flows and
    similarities stay, so they are outliers.  Returns a list of PairMatches.
    """
    from ..io.protos import PairMatches

    offsets = rng.uniform(-0.3, 0.3, (n_images, n_points, 2)).astype(np.float32)
    visible = rng.random((n_images, n_points)) < visibility
    pairs = []
    for a in range(n_images):
        for b in range(a + 1, n_images):
            shared = np.nonzero(visible[a] & visible[b])[0]
            if shared.size == 0:
                continue
            m = np.stack([shared, shared], axis=1).astype(np.uint32)
            sims = rng.uniform(0.5, 1.0, shared.size).astype(np.float32)
            d12 = np.tile(
                (offsets[b, shared] - offsets[a, shared])[:, None, None, :], (1, 3, 3, 1)
            )
            pairs.append(
                PairMatches(f"im{a:03d}", 1.0, f"im{b:03d}", 1.0, m, sims, -d12, d12)
            )
    if outlier_share > 0:
        for pair in pairs:
            k = int(round(outlier_share * pair.num_matches))
            rows = rng.choice(pair.num_matches, k, replace=False)
            pair.matches[rows, 1] = rng.integers(0, n_points, k)
    return pairs
