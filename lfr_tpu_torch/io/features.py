"""Local-feature npz file contract (copy of lfr_tpu/io/features.py).

Feature files live next to each image as ``<image>.<method>`` and contain
``keypoints`` (N x 2..4: x, y[, scale, orientation]), ``scores`` (N,) and
L2-normalized ``descriptors`` (N x D)
(reference: README.md:155-158; producers utils/extract_features_sift.py:130-141).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class FeatureSet:
    keypoints: np.ndarray    # (N, K) float, K in {2, 3, 4}; columns x, y[, scale[, ori]]
    scores: np.ndarray       # (N,)
    descriptors: np.ndarray  # (N, D), L2-normalized

    @property
    def num_features(self) -> int:
        return int(self.keypoints.shape[0])

    @property
    def xy(self) -> np.ndarray:
        return self.keypoints[:, :2]

    def completed_keypoints(self) -> np.ndarray:
        """Pad keypoints to N x 4 with scale=1, orientation=0
        (reference: colmap_utils.py:64-74)."""
        kp = self.keypoints
        n, k = kp.shape
        if k >= 4:
            return kp[:, :4]
        pad = [kp]
        if k == 2:
            pad.append(np.ones((n, 1), dtype=kp.dtype))
            pad.append(np.zeros((n, 1), dtype=kp.dtype))
        elif k == 3:
            pad.append(np.zeros((n, 1), dtype=kp.dtype))
        return np.hstack(pad)


def feature_path(image_path: str, method_name: str) -> str:
    """``<image>.<method>`` next to the image
    (reference: compute_match_graph.py:117-119)."""
    return f"{image_path}.{method_name}"


def load_features(image_path: str, method_name: Optional[str] = None) -> FeatureSet:
    path = image_path if method_name is None else feature_path(image_path, method_name)
    with np.load(path, allow_pickle=True) as data:
        keypoints = np.asarray(data["keypoints"], dtype=np.float64)
        descriptors = np.asarray(data["descriptors"], dtype=np.float32)
        if "scores" in data:
            scores = np.asarray(data["scores"], dtype=np.float32)
        else:
            scores = np.zeros(keypoints.shape[0], dtype=np.float32)
    if keypoints.ndim != 2:
        keypoints = keypoints.reshape(-1, 2)
    return FeatureSet(keypoints, scores, descriptors)


def save_features(
    image_path: str,
    keypoints: np.ndarray,
    descriptors: np.ndarray,
    scores: Optional[np.ndarray] = None,
    method_name: Optional[str] = None,
) -> str:
    path = image_path if method_name is None else feature_path(image_path, method_name)
    if scores is None:
        scores = np.zeros(keypoints.shape[0])
    with open(path, "wb") as fh:
        np.savez(fh, keypoints=keypoints, scores=scores, descriptors=descriptors)
    return path


def list_images_with_features(image_dir: str, method_name: str):
    """Yield (image_name, feature_path) for every feature file in a directory."""
    suffix = f".{method_name}"
    for name in sorted(os.listdir(image_dir)):
        if name.endswith(suffix):
            yield name[: -len(suffix)], os.path.join(image_dir, name)
