"""Feature extraction CLI (port of lfr_tpu/pipelines/extract_features.py):
images directory -> per-image npz feature files.

    python -m lfr_tpu_torch extract --image_path D --method_name sift [--device cpu]

Images are capped at ``max_edge`` (INTER_AREA, as OpenCV's), features are
extracted on the device, and keypoints are rescaled to original-image
pixels before ``<image>.<method>`` is written beside each image.  The walk
is recursive.  A file is skipped only when it is neither PNG nor JPEG by
its signature (the ``.sift`` files beside the images, for instance); an
image the port cannot decode (a progressive JPEG, say) raises and names
the file, where the JAX package, reading with ``cv2``, would decode it.

SIFT and DoH run three images deep: image N+1 is dispatched before image N
is collected, so the host's decode and writes overlap the device (torch's
launches return before the device finishes; ``collect`` is where ``.cpu()``
waits).  SURF's non-max suppression runs on the host, so it runs one image
at a time.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..device import resolve_device
from ..io import features as features_io
from ..io import images as images_io
from ..io.png import SIGNATURE as PNG_SIGNATURE
from ..ops import doh, sift, surf

EXTRACTORS: Dict[str, Callable] = {}

#: Images in flight in the dispatch / collect pipeline.
PIPELINE_DEPTH = 3


def register_extractor(name: str):
    def wrap(fn):
        EXTRACTORS[name] = fn
        return fn

    return wrap


@register_extractor("sift")
def _sift(image: np.ndarray, max_features: int, device="cuda"):
    return sift.extract_sift(image, max_features=max_features, device=device)


_sift.dispatch = sift.dispatch_sift
_sift.collect = sift.collect_sift


@register_extractor("surf")
def _surf(image: np.ndarray, max_features: int, device="cuda"):
    """Box-filter det-of-Hessian + Haar extended descriptors
    (reference: utils/extract_features_surf.py:37-58)."""
    return surf.extract_surf(image, max_features=max_features, device=device)


#: The reference rescales only x, y for SURF: size and angle stay at the
#: extraction resolution (extract_features_surf.py:66-69); SIFT rescales
#: its scale column too (extract_features_sift.py:79-111).
_surf.scale_column = False


@register_extractor("doh")
def _doh(image: np.ndarray, max_features: int, device="cuda"):
    """Gaussian det-of-Hessian blobs with SIFT-style descriptors."""
    return doh.extract_doh(image, max_features=max_features, device=device)


_doh.dispatch = doh.dispatch_doh
_doh.collect = doh.collect_doh


def _is_image_file(path: str) -> bool:
    """True for a PNG or JPEG file by its signature."""
    with open(path, "rb") as fh:
        head = fh.read(len(PNG_SIGNATURE))
    return head.startswith(PNG_SIGNATURE) or head.startswith(b"\xff\xd8")


def extract_directory(
    image_path: str,
    method_name: str,
    max_edge: int = 1600,
    max_features: int = 4096,
    output_extension: str = None,
    verbose: bool = True,
    device="cuda",
    timing: Optional[Dict[str, float]] = None,
) -> int:
    """Extract features for every image under ``image_path``; returns the
    image count.  ``timing``, when given, accumulates host seconds per span:
    ``decode`` (read + resize), ``dispatch`` (gray, pad, upload and the
    launches), ``collect`` (waiting for the device, the copy back and the
    host tail) and ``write`` (rescale + npz)."""
    extractor = EXTRACTORS.get(method_name)
    if extractor is None:
        raise ValueError(
            f"no extractor registered for {method_name!r}; available: {sorted(EXTRACTORS)}"
        )
    dev = resolve_device(device)
    ext = (output_extension or f".{method_name}").lstrip(".")
    dispatch = getattr(extractor, "dispatch", None)
    collect = getattr(extractor, "collect", None)
    spans = {} if timing is None else timing

    def timed(span, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        spans[span] = spans.get(span, 0.0) + time.perf_counter() - t0
        return out

    def write(name, path, h, w, factor, keypoints, scores, descriptors):
        # Back to original-image coordinates
        # (reference: extract_features_surf.py:66-69).
        keypoints = keypoints.copy()
        keypoints[:, :2] *= factor
        if keypoints.shape[1] > 2 and getattr(extractor, "scale_column", True):
            keypoints[:, 2] *= factor
        features_io.save_features(path, keypoints, descriptors, scores, method_name=ext)
        if verbose:
            print(f"[{name}] {h}x{w}, factor {factor:.4f}; {keypoints.shape[0]} keypoints",
                  file=sys.stderr, flush=True)

    def finish(rec):
        features = timed("collect", collect, rec[5])
        timed("write", write, *rec[:5], *features)

    def load(path):
        try:
            image = images_io.load_image_rgb(path)
        except ValueError as err:
            raise ValueError(f"{path}: {err}") from err
        h, w = image.shape[:2]
        factor = max(1.0, max(h, w) / max_edge)
        return image.shape[:2], factor, images_io.resize_by_factor(image, factor)

    # Recursive discovery: real datasets nest images (ETH3D's undistorted
    # archives put them under images/dslr_images_undistorted/); names stay
    # relative, so features land next to each image.
    names = []
    for dirpath, dirnames, filenames in os.walk(image_path):
        dirnames.sort()
        rel = os.path.relpath(dirpath, image_path)
        for fn in sorted(filenames):
            names.append(fn if rel == "." else os.path.join(rel, fn))

    count = 0
    pending = collections.deque()  # (name, path, h, w, factor, handle)
    for name in names:
        path = os.path.join(image_path, name)
        if not _is_image_file(path):
            continue
        (h, w), factor, small = timed("decode", load, path)
        count += 1
        if dispatch is None:
            features = timed("collect", extractor, small, max_features, dev)
            timed("write", write, name, path, h, w, factor, *features)
            continue
        handle = timed("dispatch", dispatch, small, max_features=max_features, device=dev)
        pending.append((name, path, h, w, factor, handle))
        if len(pending) >= PIPELINE_DEPTH:
            finish(pending.popleft())
    while pending:
        finish(pending.popleft())
    return count


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="feature extraction (SIFT, SURF, DoH)")
    parser.add_argument("--image_path", required=True)
    parser.add_argument("--method_name", required=True, choices=sorted(EXTRACTORS))
    parser.add_argument("--max_edge", type=int, default=1600)
    parser.add_argument("--max_features", type=int, default=4096)
    parser.add_argument("--output_extension", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    extract_directory(
        args.image_path,
        args.method_name,
        args.max_edge,
        args.max_features,
        args.output_extension,
        device=args.device,
    )


if __name__ == "__main__":
    main()
