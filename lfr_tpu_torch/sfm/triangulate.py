"""Fixed-pose multi-view triangulation (port of lfr_tpu/sfm/triangulate.py).

Replaces ``colmap point_triangulator`` with pose and intrinsics fixed and
points refined alone.  Feature tracks come from the database's verified
matches by union-find on the host (numpy); the tracks triangulate as
batched DLT + point-only Gauss-Newton in torch on the device, in float32
as the JAX package runs them (it never enables x64), so the angle and
reprojection gates keep the same points.  Tracks are grouped by padded
observation count (OBS_BUCKETS); a group runs in chunks sized by memory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..io import colmap_db as db_mod
from ..io import colmap_model as model_mod
from ..utils import timing
from . import cameras as cam_mod
from . import geometry

#: COLMAP point_triangulator-style defaults.
MAX_REPROJ_ERROR_PX = 4.0
MIN_TRI_ANGLE_DEG = 1.5
MIN_TRACK_LENGTH = 2
GN_ITERATIONS = 10

#: Observation-count padding buckets (longer tracks are cut to the last).
OBS_BUCKETS = (4, 8, 16, 32, 64, 128, 256)

#: Tracks per device chunk times the squared bucket size (the pairwise
#: angle tensor is tracks x V x V).
CHUNK_ELEMENTS = 1 << 22


# ---------------------------------------------------------------------------
# Track building from verified matches
# ---------------------------------------------------------------------------


def build_feature_tracks(
    num_features: Dict[int, int],
    pair_matches: List[Tuple[int, int, np.ndarray]],
) -> List[np.ndarray]:
    """Union-find over per-pair inlier matches -> feature tracks.

    Args:
      num_features: image_id -> keypoint count.
      pair_matches: (image_id1, image_id2, matches (K, 2)) triples.

    Returns a list of (track_len, 2) arrays of (image_id, feature_idx),
    keeping only tracks with at most one feature per image (conflicting
    merges are rejected, as in the solver's MSF).
    """
    image_ids = sorted(num_features)
    offsets = {}
    total = 0
    for iid in image_ids:
        offsets[iid] = total
        total += num_features[iid]

    parent = np.arange(total, dtype=np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    # Image sets per root for the disjointness test.
    img_sets: Dict[int, set] = {}

    node_image = np.empty(total, dtype=np.int64)
    for iid in image_ids:
        node_image[offsets[iid] : offsets[iid] + num_features[iid]] = iid

    for id1, id2, matches in pair_matches:
        o1, o2 = offsets[id1], offsets[id2]
        for f1, f2 in matches:
            a = find(o1 + int(f1))
            b = find(o2 + int(f2))
            if a == b:
                continue
            sa = img_sets.get(a, {int(node_image[a])})
            sb = img_sets.get(b, {int(node_image[b])})
            if sa & sb:
                continue
            if len(sa) < len(sb):
                a, b, sa, sb = b, a, sb, sa
            parent[b] = a
            sa |= sb
            img_sets[a] = sa
            img_sets.pop(b, None)

    # Collect members per root.
    roots = np.array([find(i) for i in range(total)])
    order = np.argsort(roots, kind="stable")
    roots_sorted = roots[order]
    boundaries = np.nonzero(np.diff(roots_sorted))[0] + 1
    groups = np.split(order, boundaries)

    tracks = []
    image_starts = np.array([offsets[iid] for iid in image_ids])
    for g in groups:
        if g.shape[0] < MIN_TRACK_LENGTH:
            continue
        img_idx = np.searchsorted(image_starts, g, side="right") - 1
        iids = np.array([image_ids[k] for k in img_idx])
        feats = g - image_starts[img_idx]
        tracks.append(np.stack([iids, feats], axis=1))
    return tracks


# ---------------------------------------------------------------------------
# Batched triangulation + point-only refinement
# ---------------------------------------------------------------------------


def _project(X, P):
    """Pixels (T, V, 2), guarded depth (T, V) and depth (T, V) of points
    X (T, 3) through cameras P (T, V, 3, 4)."""
    p = (P[..., :3] * X[:, None, None, :]).sum(-1) + P[..., 3]
    depth = p[..., 2]
    guarded = torch.where(depth.abs() < 1e-12, torch.full_like(depth, 1e-12), depth)
    return p[..., :2] / guarded[..., None], guarded, depth


def _residual_cost(X, P, uv, m):
    proj, _, _ = _project(X, P)
    return (((proj - uv) * m[..., None]) ** 2).sum((-2, -1))


def _triangulate_and_refine(P, uv, mask, centers, iterations: int = GN_ITERATIONS):
    """Batched DLT + point-only Gauss-Newton.

    P: (T, V, 3, 4); uv: (T, V, 2); mask: (T, V); centers: (T, V, 3).
    Returns packed rows (T, 4 + 2V): [X (3), max_angle, reproj_sq (V),
    depths (V)], one read-back per chunk.

    Each step solves (JᵀJ + 1e-6 I) dX = Jᵀr with the reprojection's
    Jacobian in closed form, d(p01 / w)/dX = (P01 - proj P2) / w (the P2
    term vanishes where the depth guard holds w at 1e-12), and keeps the
    step only if it lowers the masked squared residual.  A singular system
    gives NaN and keeps X, as JAX's LU does.
    """
    m = mask.to(uv.dtype)
    X = geometry.triangulate_dlt(P, uv, mask)
    eye = 1e-6 * torch.eye(3, dtype=uv.dtype, device=uv.device)
    for _ in range(iterations):
        proj, guarded, depth = _project(X, P)
        r = (proj - uv) * m[..., None]  # (T, V, 2)
        live = (depth.abs() >= 1e-12).to(uv.dtype)
        J = (P[..., :2, :3] - proj[..., None] * (P[..., 2:3, :3] * live[..., None, None])
             ) / guarded[..., None, None] * m[..., None, None]  # (T, V, 2, 3)
        J = J.flatten(1, 2)  # (T, 2V, 3)
        H = J.transpose(1, 2) @ J + eye
        g = (J * r.flatten(1, 2)[..., None]).sum(1)
        dX, info = torch.linalg.solve_ex(H, g[..., None], check_errors=False)
        dX = torch.where((info != 0)[:, None, None], torch.nan, dX)[..., 0]
        X_new = X - dX
        better = _residual_cost(X_new, P, uv, m) < (r**2).sum((-2, -1))
        X = torch.where(better[:, None], X_new, X)

    proj, _, depths = _project(X, P)
    reproj_sq = ((proj - uv) ** 2).sum(-1)
    # Max pairwise triangulation angle across valid observation pairs.
    d = X[:, None, :] - centers
    dn = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    cosang = dn @ dn.transpose(1, 2)
    ang = torch.arccos(cosang.clamp(-1.0, 1.0))
    pair_ok = mask[:, :, None] & mask[:, None, :]
    max_angle = torch.where(pair_ok, ang, torch.zeros_like(ang)).amax((-2, -1))
    return torch.cat([X, max_angle[:, None], reproj_sq, depths], dim=1)


@dataclasses.dataclass
class TriangulationResult:
    model: model_mod.Model
    stats: dict
    num_tracks: int = 0  # candidate tracks from the union-find


def triangulate_model(
    database: db_mod.ColmapDatabase,
    empty_model: model_mod.Model,
    min_track_length: int = MIN_TRACK_LENGTH,
    max_reproj_error: float = MAX_REPROJ_ERROR_PX,
    min_tri_angle_deg: float = MIN_TRI_ANGLE_DEG,
    verbose: bool = False,
    device="cuda",
    spans: Optional[timing.Spans] = None,
    iterations: int = GN_ITERATIONS,
) -> TriangulationResult:
    """Triangulate all feature tracks against fixed poses.

    ``spans`` receives the stages ``tracks`` (union-find), ``pack`` (host
    arrays), ``device`` (upload, DLT + GN, read-back) and ``gate`` (the
    angle, depth and reprojection gates and the model's points);
    ``iterations``: Gauss-Newton steps per track."""
    dev = resolve_device(device)
    spans = timing.Spans() if spans is None else spans
    images = {im.image_id: im for im in empty_model.images.values()}
    cams = empty_model.cameras

    with spans.span("tracks"):
        # Per-image keypoints and projection data.
        kps: Dict[int, np.ndarray] = {}
        norm_uv: Dict[int, np.ndarray] = {}
        Ps: Dict[int, np.ndarray] = {}
        centers: Dict[int, np.ndarray] = {}
        for iid, im in images.items():
            kp = database.keypoints(iid)
            kps[iid] = kp
            cam = cams[im.camera_id]
            R = model_mod.qvec_to_rotmat(im.qvec)
            t = im.tvec
            # Undistorted normalized coordinates: P = [R | t], uv = K^-1 x.
            if kp.shape[0]:
                norm_uv[iid] = cam_mod.pixel_to_normalized(cam, kp[:, :2].astype(np.float64))
            else:
                norm_uv[iid] = np.zeros((0, 2))
            Ps[iid] = np.concatenate([R, t[:, None]], axis=1)
            centers[iid] = -R.T @ t

        pair_matches = [
            (id1, id2, m) for id1, id2, m, _ in database.all_two_view_geometries() if m.shape[0]
        ]
        num_features = {iid: kps[iid].shape[0] for iid in images}
        tracks = build_feature_tracks(num_features, pair_matches)
    if verbose:
        print(f"[triangulate] {len(tracks)} candidate tracks")

    focal = {iid: cam_mod.calibration_matrix(cams[images[iid].camera_id])[0, 0] for iid in images}
    points3D: Dict[int, model_mod.Point3D] = {}
    per_image_obs: Dict[int, List[Tuple[int, int]]] = {iid: [] for iid in images}
    next_pid = 1

    by_bucket: Dict[int, List[np.ndarray]] = {}
    for tr in tracks:
        v = tr.shape[0]
        bucket = next((b for b in OBS_BUCKETS if v <= b), None)
        if bucket is None:
            tr = tr[: OBS_BUCKETS[-1]]
            bucket = OBS_BUCKETS[-1]
        by_bucket.setdefault(bucket, []).append(tr)

    min_angle_rad = np.deg2rad(min_tri_angle_deg)

    for bucket, trs_all in sorted(by_bucket.items()):
        size = max(1, CHUNK_ELEMENTS // (bucket * bucket))
        for start in range(0, len(trs_all), size):
            trs = trs_all[start : start + size]
            T = len(trs)
            with spans.span("pack"):
                P = np.zeros((T, bucket, 3, 4), np.float64)
                uv = np.zeros((T, bucket, 2), np.float64)
                mask = np.zeros((T, bucket), bool)
                ctr = np.zeros((T, bucket, 3), np.float64)
                for k, tr in enumerate(trs):
                    for v, (iid, fidx) in enumerate(tr):
                        P[k, v] = Ps[iid]
                        uv[k, v] = norm_uv[iid][fidx]
                        ctr[k, v] = centers[iid]
                        mask[k, v] = True
            with spans.span("device"):
                arrays = [torch.as_tensor(a, dtype=torch.float32) for a in (P, uv, ctr)]
                P_t, uv_t, ctr_t = (a.to(dev) for a in arrays)
                packed = _triangulate_and_refine(
                    P_t, uv_t, torch.from_numpy(mask).to(dev), ctr_t, iterations
                ).cpu().numpy()
            with spans.span("gate"):
                pts = packed[:, :3]
                max_angle = packed[:, 3]
                reproj_sq = packed[:, 4 : 4 + bucket]
                depths = packed[:, 4 + bucket :]

                for k, tr in enumerate(trs):
                    if not np.isfinite(pts[k]).all():
                        continue
                    if max_angle[k] < min_angle_rad:
                        continue
                    # Per-observation gating: positive depth + pixel reproj error.
                    keep = []
                    errs = []
                    for v, (iid, fidx) in enumerate(tr):
                        err_px = np.sqrt(reproj_sq[k, v]) * focal[iid]
                        if depths[k, v] > 0 and err_px <= max_reproj_error:
                            keep.append((iid, fidx))
                            errs.append(err_px)
                    if len(keep) < min_track_length:
                        continue
                    pid = next_pid
                    next_pid += 1
                    image_ids = np.array([iid for iid, _ in keep])
                    point2D_idxs = np.array([fi for _, fi in keep])
                    err = float(np.mean(errs))
                    points3D[pid] = model_mod.Point3D(
                        pid, pts[k].astype(np.float64), np.full(3, 128, np.uint8), err,
                        image_ids, point2D_idxs,
                    )
                    for iid, fi in keep:
                        per_image_obs[iid].append((int(fi), pid))

    # Assemble the output model: per-image point lists reference keypoints.
    out = model_mod.Model(cameras=dict(cams), images={}, points3D=points3D)
    for iid, im in images.items():
        kp = kps[iid]
        xys = kp[:, :2].astype(np.float64) if kp.shape[0] else np.zeros((0, 2))
        pids = np.full(xys.shape[0], -1, dtype=np.int64)
        for fi, pid in per_image_obs[iid]:
            pids[fi] = pid
        out.images[iid] = model_mod.Image(
            iid, im.qvec, im.tvec, im.camera_id, im.name, xys, pids
        )

    return TriangulationResult(out, analyze_model(out), len(tracks))


def analyze_model(model: model_mod.Model) -> dict:
    """COLMAP model_analyzer-equivalent statistics
    (reference: colmap_utils.py:266-294)."""
    n_points = len(model.points3D)
    n_obs = sum(len(p.image_ids) for p in model.points3D.values())
    reg_images = sum(
        1 for im in model.images.values() if (im.point3D_ids >= 0).any()
    )
    mean_track = n_obs / n_points if n_points else 0.0
    obs_per_image = n_obs / reg_images if reg_images else 0.0
    mean_err = (
        sum(p.error * len(p.image_ids) for p in model.points3D.values()) / n_obs
        if n_obs
        else 0.0
    )
    return dict(
        num_reg_images=reg_images,
        num_sparse_points=n_points,
        num_observations=n_obs,
        mean_track_length=round(mean_track, 6),
        num_observations_per_image=round(obs_per_image, 6),
        mean_reproj_error=round(mean_err, 6),
    )
