"""Synthetic images and keypoints for the port's tests and chip smoke run.

A numpy-only copy of ``textured_image``, ``shifted_pair`` and
``planted_features`` from lfr_tpu.utils.synthetic: the same seed gives the
same arrays in both packages.
"""

from __future__ import annotations

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
