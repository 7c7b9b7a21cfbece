"""Reconstruction comparison on commonly registered images (port of
lfr_tpu/eval/compare.py).

Restrict both models to the images registered in both, then report the
analyzer statistics side by side:

    python -m lfr_tpu_torch.eval.compare --raw_model RAW --ref_model REF

:func:`feature_agreement` compares two extractions of one image (two
devices, two packages, or a run against a control).
"""

from __future__ import annotations

import copy
from typing import Dict, Set, Tuple

import numpy as np

from ..io import colmap_model as model_mod
from ..sfm.triangulate import analyze_model


def registered_image_names(model: model_mod.Model) -> Set[str]:
    return {
        im.name for im in model.images.values() if (im.point3D_ids >= 0).any()
    }


def restrict_to_images(model: model_mod.Model, keep_names: Set[str]) -> model_mod.Model:
    """Drop images not in ``keep_names`` and prune their observations."""
    out = model_mod.Model(cameras=dict(model.cameras))
    keep_ids = set()
    for im in model.images.values():
        if im.name in keep_names:
            out.images[im.image_id] = copy.deepcopy(im)
            keep_ids.add(im.image_id)

    for pid, pt in model.points3D.items():
        mask = np.isin(pt.image_ids, list(keep_ids))
        if mask.sum() < 2:
            # Track too short after restriction: drop the point entirely.
            for iid, fi in zip(pt.image_ids[mask], pt.point2D_idxs[mask]):
                img = out.images.get(int(iid))
                if img is not None and fi < img.point3D_ids.shape[0]:
                    img.point3D_ids[int(fi)] = -1
            continue
        out.points3D[pid] = model_mod.Point3D(
            pid, pt.xyz.copy(), pt.rgb.copy(), pt.error,
            pt.image_ids[mask].copy(), pt.point2D_idxs[mask].copy(),
        )
    # Clear stale references for dropped points.
    kept_pids = set(out.points3D)
    for img in out.images.values():
        stale = ~np.isin(img.point3D_ids, list(kept_pids)) & (img.point3D_ids >= 0)
        img.point3D_ids[stale] = -1
    return out


def compare_reconstructions(
    raw_model: model_mod.Model, ref_model: model_mod.Model
) -> Tuple[Dict, Dict]:
    """Stats for (raw, refined) restricted to commonly registered images."""
    common = registered_image_names(raw_model) & registered_image_names(ref_model)
    raw_common = restrict_to_images(raw_model, common)
    ref_common = restrict_to_images(ref_model, common)
    return analyze_model(raw_common), analyze_model(ref_common)


def feature_agreement(a, b, px: float = 1e-2, desc_atol: float = 4e-3) -> Dict:
    """How two feature sets (keypoints (K, >=2), scores, descriptors) of one
    image agree: ``matched``, the share of ``a``'s keypoints with one of
    ``b``'s within ``px`` pixels (nearest in x, y), over the larger count;
    ``descriptors``, the share of those matched pairs whose descriptors
    differ by at most ``desc_atol`` in every component."""
    from scipy.spatial import cKDTree

    ka, da = np.asarray(a[0]), np.asarray(a[2])
    kb, db = np.asarray(b[0]), np.asarray(b[2])
    out = {"keypoints": [int(len(ka)), int(len(kb))], "matched": 0.0, "descriptors": 0.0}
    if not len(ka) or not len(kb):
        return out
    dist, idx = cKDTree(kb[:, :2]).query(ka[:, :2])
    m = dist <= px
    out["matched"] = float(m.sum() / max(len(ka), len(kb)))
    if m.any():
        diff = np.abs(da[m].astype(np.float64) - db[idx[m]]).max(axis=1)
        out["descriptors"] = float((diff <= desc_atol).mean())
    return out


def main(argv=None) -> None:
    """CLI mirroring the reference comparator
    (reference: local-feature-evaluation/compare_reconstructions.py:16-107)."""
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="compare two reconstructions on commonly registered images"
    )
    parser.add_argument("--raw_model", required=True, help="raw model directory")
    parser.add_argument("--ref_model", required=True, help="refined model directory")
    args = parser.parse_args(argv)

    raw = model_mod.read_model(args.raw_model)
    ref = model_mod.read_model(args.ref_model)
    common = registered_image_names(raw) & registered_image_names(ref)
    raw_stats, ref_stats = compare_reconstructions(raw, ref)
    print(f"common registered images: {len(common)}")
    print("raw:", json.dumps(raw_stats))
    print("ref:", json.dumps(ref_stats))


if __name__ == "__main__":
    main()
