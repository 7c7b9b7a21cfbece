"""Determinant-of-Hessian feature extraction (port of lfr_tpu/ops/doh.py).

A blob detector on the scale-normalised determinant of the Gaussian
Hessian over a scale pyramid, with orientations and 128-D descriptors from
SIFT's machinery (:mod:`.sift`): the same octave pipeline with the
det-of-Hessian stack in place of the DoG, ``min_dim`` 24 and ``SIGMA0`` 2.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import sift as sift_mod
from .matchers import strict_f32

#: Response threshold on |det H| (normalised images).
HESSIAN_THRESHOLD = 1e-6
NUM_SCALES = 3
SIGMA0 = 2.0


def _det_hessian(gauss: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalised determinant of the image Hessian, by wrap-around
    central differences (``jnp.roll``)."""
    dxx = torch.roll(gauss, -1, 1) + torch.roll(gauss, 1, 1) - 2 * gauss
    dyy = torch.roll(gauss, -1, 0) + torch.roll(gauss, 1, 0) - 2 * gauss
    dxy = (
        torch.roll(gauss, (-1, -1), (0, 1))
        - torch.roll(gauss, (-1, 1), (0, 1))
        - torch.roll(gauss, (1, -1), (0, 1))
        + torch.roll(gauss, (1, 1), (0, 1))
    ) / 4.0
    return (dxx * dyy - dxy * dxy) * sigma**4


def _sigmas():
    k = 2.0 ** (1.0 / NUM_SCALES)
    return [SIGMA0 * (k**i) for i in range(NUM_SCALES + 2)]


def _response_stack(G: torch.Tensor) -> torch.Tensor:
    """(S+2, H, W) det-of-Hessian responses of one octave's gaussians."""
    return torch.stack([_det_hessian(G[i], s) for i, s in enumerate(_sigmas())])


def _doh_pyramid(img: torch.Tensor, n_octaves: int, max_per_octave: int, threshold: float):
    """Whole-image DoH extraction on the device (see sift._sift_pyramid)."""
    sigmas = _sigmas()
    inc = [math.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-8)) for i in range(1, len(sigmas))]
    out = []
    for octave, G in enumerate(sift_mod._gaussian_octaves(img, n_octaves, SIGMA0, inc)):
        top_k = max(256, max_per_octave >> octave)
        out.append(sift_mod._device_octave_features(G, _response_stack(G), top_k, threshold, SIGMA0))
    return torch.cat([m for m, _ in out]), torch.cat([d for _, d in out])


def dispatch_doh(
    image: np.ndarray,
    max_features: int = 4096,
    max_per_octave: int = 2048,
    threshold: float = HESSIAN_THRESHOLD,
    device="cuda",
):
    """Upload and enqueue; see sift.dispatch_sift."""
    dev = resolve_device(device)
    img, true_h, true_w, n_octaves = sift_mod.prepare_image(image, 24.0, dev)
    with strict_f32():
        meta, desc = _doh_pyramid(img, n_octaves, max_per_octave, threshold)
    sizes = sift_mod.octave_sizes(n_octaves, max_per_octave)
    return meta, desc, sizes, true_h, true_w, max_features


def collect_doh(handle) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return sift_mod.collect_sift(handle)


def extract_doh(
    image: np.ndarray,
    max_features: int = 4096,
    max_per_octave: int = 2048,
    threshold: float = HESSIAN_THRESHOLD,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DoH blobs + 128-D descriptors: keypoints (K, 4) [x, y, scale,
    orientation], scores, descriptors, in input-image pixels."""
    return collect_doh(dispatch_doh(image, max_features, max_per_octave, threshold, device))
