"""ETH3D-style multi-view evaluation: accuracy and completeness against a
scan (port of lfr_tpu/eval/eth3d.py).

Given a reconstructed sparse point cloud and the ground-truth scan, per
tolerance t:

  accuracy(t)     = fraction of reconstruction points within t of the scan,
  completeness(t) = fraction of scan points within t of the reconstruction,
  F1(t)           = harmonic mean.

The scan loads from a MeshLab ``.mlp`` project (PLY references and a 4x4
alignment per mesh) or from a PLY; a scan with triangles is densely
surface-sampled (area-weighted, spacing well below the smallest tolerance),
so accuracy measures distance to the surface; a vertex-only scan falls back
to vertex distances, marked in ``evaluation_mode``.  With the ground-truth
calibration, completeness counts only scan samples visible in at least
one view (a z-buffer test, "+visibility" in the mode).

Nearest-neighbour distances take the JAX package's routes: below
``_BRUTE_FORCE_MIN_PAIRS`` query-corpus pairs, or on the CPU, scipy's
``cKDTree`` in f64 on the host; above it on the card, the brute-force
kernel of :mod:`..ops.nn_dist` in f32 (the same squared distances as the
JAX package's ``_all_min_impl``).  The point sets are uploaded on each
call.  The z-buffer runs as torch ops on the evaluation's device.
"""

from __future__ import annotations

import os
import warnings
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..config import ETH3D_TOLERANCES
from ..device import resolve_device
from ..io.colmap_model import read_ply_mesh, read_ply_xyz
from ..ops import nn_dist

#: Surface sample spacing (m): 2.5 mm, well below the 1 cm smallest tolerance.
SURFACE_SPACING = 0.0025

#: Upper bound on generated surface samples (memory guard).
MAX_SURFACE_SAMPLES = 30_000_000


def sample_mesh_surface(
    xyz: np.ndarray,
    faces: np.ndarray,
    spacing: float = SURFACE_SPACING,
    rng: np.random.Generator = None,
    max_samples: int = MAX_SURFACE_SAMPLES,
) -> np.ndarray:
    """Area-weighted uniform point samples over a triangle mesh: every
    triangle gets ceil(area / spacing^2) samples, at least one."""
    rng = rng or np.random.default_rng(0)
    a = xyz[faces[:, 0]]
    b = xyz[faces[:, 1]]
    c = xyz[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    per_tri = np.ceil(areas / (spacing * spacing)).astype(np.int64)
    per_tri = np.maximum(per_tri, 1)
    total = int(per_tri.sum())
    if total > max_samples:
        per_tri = np.maximum((per_tri * (max_samples / total)).astype(np.int64), 1)
        total = int(per_tri.sum())
    tri_idx = np.repeat(np.arange(faces.shape[0]), per_tri)
    u = rng.random(total)
    v = rng.random(total)
    flip = u + v > 1.0
    u[flip] = 1.0 - u[flip]
    v[flip] = 1.0 - v[flip]
    return (
        a[tri_idx]
        + u[:, None] * (b[tri_idx] - a[tri_idx])
        + v[:, None] * (c[tri_idx] - a[tri_idx])
    )


def load_mlp_scan(mlp_path: str, surface_spacing: float = SURFACE_SPACING):
    """Load and transform all meshes of a MeshLab project.

    Returns (points, mode): surface samples when any mesh has triangles
    (mode "surface"), otherwise raw vertices (mode "vertex")."""
    tree = ET.parse(mlp_path)
    base = os.path.dirname(mlp_path)
    points = []
    any_faces = False
    for mesh in tree.iter("MLMesh"):
        filename = mesh.get("filename")
        matrix = np.eye(4)
        for mat in mesh.iter("MLMatrix44"):
            vals = [float(v) for v in mat.text.split()]
            matrix = np.array(vals).reshape(4, 4)
        xyz, faces = read_ply_mesh(os.path.join(base, filename))
        if faces is not None and surface_spacing:
            xyz = sample_mesh_surface(xyz, faces, surface_spacing)
            any_faces = True
        xyz_h = np.hstack([xyz, np.ones((xyz.shape[0], 1))])
        points.append((xyz_h @ matrix.T)[:, :3])
    if not points:
        raise ValueError(f"no meshes found in {mlp_path}")
    return np.concatenate(points), ("surface" if any_faces else "vertex")


#: Below this many query x corpus pairs the host KD-tree runs (exact, and
#: its build is cheap at that size); above it, on the card, the kernel.
_BRUTE_FORCE_MIN_PAIRS = int(1e8)


def _device_points(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """(N, 3) f32 copy of ``arr`` on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)


def _use_brute(nq: int, nc: int, device: torch.device) -> bool:
    return device.type == "cuda" and nq * nc >= _BRUTE_FORCE_MIN_PAIRS


def _min_dists(queries: np.ndarray, corpus: np.ndarray, device="cuda") -> np.ndarray:
    """Nearest-neighbour distance of each query to the corpus, f64 on the
    host: the KD-tree or the brute-force kernel by problem size."""
    dev = resolve_device(device)
    if _use_brute(queries.shape[0], corpus.shape[0], dev):
        q, c = _device_points(queries, dev), _device_points(corpus, dev)
        return nn_dist.min_dists(q, c).cpu().numpy().astype(np.float64)
    d, _ = cKDTree(corpus).query(queries, k=1, workers=-1)
    return d


def _fractions_within(
    queries: np.ndarray, corpus: np.ndarray, tolerances: Sequence[float], device="cuda"
) -> List[float]:
    """Fraction of queries within each tolerance of the corpus; on the
    brute-force route only the per-tolerance counts leave the device."""
    dev = resolve_device(device)
    if not _use_brute(queries.shape[0], corpus.shape[0], dev):
        d, _ = cKDTree(corpus).query(queries, k=1, workers=-1)
        return [float((d <= t).mean()) for t in tolerances]
    counts = nn_dist.count_within(_device_points(queries, dev), _device_points(corpus, dev),
                                  tolerances)
    return [float(n) / queries.shape[0] for n in counts]


# ---------------------------------------------------------------------------
# Scan-sample visibility (z-buffer approximation)
# ---------------------------------------------------------------------------
#
# A scan surface sample counts for COMPLETENESS only when it is visible in
# at least ``min_views`` calibrated ground-truth views: project every sample
# into each view, keep the nearest depth per coarse pixel bin, and accept
# samples within a relative depth tolerance of that minimum.  Accuracy keeps
# the full scan as its corpus.  Distortion is ignored.

#: Z-buffer bin size in pixels.
_VIS_GRID_PX = 8

#: Every k-th sample (of the unpadded scan) splats into the depth buffer;
#: all samples are depth-tested.
_VIS_DEPTH_SUBSAMPLE = 4

#: A sample passes the depth test within this relative tolerance of its
#: bin's minimum depth (plus 1e-9).
_VIS_DEPTH_TOL_REL = 0.02


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once, as XLA's fused multiply-add on the CPU
    gives it: the f32 product is exact in f64, so only the f64 sum can round
    before the f32 rounding (a double rounding one sum in about 2^29 sees)."""
    return (a.double() * b.double() + c.double()).float()


def _visible_counts(pts: torch.Tensor, Rs, ts, intr, wh, grid_w: int, n_bins: int) -> torch.Tensor:
    """(N, 3) f32 points x C cameras -> (N,) int32 count of views in which
    each point passes the z-buffer test.  The arithmetic is the JAX
    package's ``_visibility_impl`` as XLA compiles it on the CPU (camera
    coordinates as fma(z, R2, fma(y, R1, x R0)) + t, the depth limit as
    fma(dmin, 1.02, 1e-9)), in element-wise ops that give the same bits on
    the CPU and the card."""
    dev = pts.device
    x, y, z_w = pts[:, 0], pts[:, 1], pts[:, 2]
    views = torch.zeros(pts.shape[0], dtype=torch.int32, device=dev)
    sub = slice(None, None, _VIS_DEPTH_SUBSAMPLE)
    tol = torch.tensor(1.0 + _VIS_DEPTH_TOL_REL, dtype=torch.float32, device=dev)
    eps = torch.tensor(1e-9, dtype=torch.float32, device=dev)
    for R, t, k4, whc in zip(Rs, ts, intr, wh):
        R, t, k4, whc = (torch.from_numpy(a).to(dev) for a in (R, t, k4, whc))
        cam = [_fma(z_w, R[k, 2], _fma(y, R[k, 1], x * R[k, 0])) + t[k] for k in range(3)]
        z = cam[2]
        front = z > 1e-9
        zs = torch.where(front, z, torch.ones_like(z))
        px = k4[0] * cam[0] / zs + k4[2]
        py = k4[1] * cam[1] / zs + k4[3]
        gx = torch.floor(px / _VIS_GRID_PX)
        gy = torch.floor(py / _VIS_GRID_PX)
        wg = torch.ceil(whc[0] / _VIS_GRID_PX)
        hg = torch.ceil(whc[1] / _VIS_GRID_PX)
        inb = front & (gx >= 0) & (gy >= 0) & (gx < wg) & (gy < hg)
        cell = torch.where(inb, gy, 0).long() * grid_w + torch.where(inb, gx, 0).long()
        bins = torch.where(inb, cell, n_bins)
        # Slot n_bins collects the samples out of frame and is never read
        # as a real bin (the JAX package's mode="drop").
        depth = torch.full((n_bins + 1,), torch.inf, dtype=torch.float32, device=dev)
        splat = torch.where(inb, z, torch.full_like(z, torch.inf))
        depth.scatter_reduce_(0, bins[sub], splat[sub], reduce="amin")
        limit = _fma(depth[bins], tol, eps)
        views += (inb & (z <= limit)).int()
    return views


def scan_visibility_mask(scan: np.ndarray, model, min_views: int = 1, device="cuda") -> np.ndarray:
    """(N,) bool: scan samples visible in at least ``min_views`` views of
    ``model`` (an ``io.colmap_model.Model``: ground-truth calibration,
    world-to-camera poses).  Pinhole projection from the calibration
    matrix; distortion is not applied."""
    from ..io.colmap_model import qvec_to_rotmat
    from ..sfm.cameras import calibration_matrix

    dev = resolve_device(device)
    images = sorted(model.images.values(), key=lambda im: im.image_id)
    if not images or scan.shape[0] == 0:
        return np.ones(scan.shape[0], bool)
    Rs = np.stack([qvec_to_rotmat(im.qvec) for im in images]).astype(np.float32)
    ts = np.stack([im.tvec for im in images]).astype(np.float32)
    intr, wh = [], []
    for im in images:
        cam = model.cameras[im.camera_id]
        K = calibration_matrix(cam)
        intr.append([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
        wh.append([cam.width, cam.height])
    intr = np.asarray(intr, np.float32)
    wh = np.asarray(wh, np.float32)
    grid_w = int(np.ceil(wh[:, 0].max() / _VIS_GRID_PX))
    grid_h = int(np.ceil(wh[:, 1].max() / _VIS_GRID_PX))
    pts = _device_points(scan, dev)
    views = _visible_counts(pts, Rs, ts, intr, wh, grid_w, max(grid_w * grid_h, 1))
    return views.cpu().numpy() >= min_views


#: (scan path, scan mtime, model path, model mtime, min_views) -> visible
#: scan samples (one entry: the ref and raw evaluations of a run share it).
_visible_scan_cache: Dict[tuple, np.ndarray] = {}


def _model_dir_mtime(gt_model_path: str) -> float:
    """Latest mtime over the model files (cameras/images/points3D .txt or
    .bin): the disk cache's validity signature for the calibration."""
    latest = 0.0
    try:
        for name in os.listdir(gt_model_path):
            if name.split(".")[0] in ("cameras", "images", "points3D"):
                latest = max(latest, os.path.getmtime(os.path.join(gt_model_path, name)))
    except OSError:
        pass
    return latest


def _visible_scan_cached(
    scan: np.ndarray, ground_truth: str, gt_model_path: str, min_views: int, device="cuda"
) -> np.ndarray:
    model_abspath = os.path.abspath(gt_model_path)
    model_mtime = _model_dir_mtime(gt_model_path)
    key = (
        os.path.abspath(ground_truth),
        os.path.getmtime(ground_truth),
        model_abspath,
        model_mtime,
        min_views,
    )
    hit = _visible_scan_cache.get(key)
    if hit is not None:
        return hit
    # Disk cache beside the scan, valid for the same scan and calibration
    # files (paths and mtimes), as the in-memory key.
    disk = None
    if not os.environ.get("LFR_NO_SCAN_CACHE"):
        disk = f"{key[0]}.visible-{min_views}-{scan.shape[0]}.npz"
    if disk and os.path.exists(disk):
        try:
            with np.load(disk) as z:
                if (
                    "model_path" in z.files
                    and float(z["mtime"]) == key[1]
                    and str(z["model_path"]) == model_abspath
                    and float(z["model_mtime"]) == model_mtime
                ):
                    visible = z["visible"]
                    _visible_scan_cache.clear()
                    _visible_scan_cache[key] = visible
                    return visible
        except (OSError, ValueError, KeyError):
            pass
    from ..io.colmap_model import read_model

    mask = scan_visibility_mask(scan, read_model(gt_model_path), min_views, device=device)
    visible = np.ascontiguousarray(scan[mask])
    if disk is not None:
        try:
            tmp = disk + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez(
                    fh,
                    visible=visible.astype(np.float32),
                    mtime=key[1],
                    model_path=model_abspath,
                    model_mtime=model_mtime,
                )
            os.replace(tmp, disk)
        except OSError:
            pass
    _visible_scan_cache.clear()
    _visible_scan_cache[key] = visible
    return visible


def evaluate_point_cloud(
    reconstruction: np.ndarray,
    scan: np.ndarray,
    tolerances: Sequence[float] = ETH3D_TOLERANCES,
    mode: str = "vertex",
    scan_completeness: np.ndarray = None,
    device="cuda",
) -> Dict[str, List[float]]:
    """Accuracy, completeness and F1 at each tolerance.

    ``scan_completeness`` (default: ``scan``) is the query set of the
    completeness direction: the visible subset, while accuracy keeps the
    full scan as its corpus."""
    if scan_completeness is None:
        scan_completeness = scan
    if reconstruction.shape[0] == 0 or scan.shape[0] == 0:
        z = [0.0] * len(tolerances)
        return {
            "tolerances": list(tolerances),
            "accuracies": z,
            "completenesses": z,
            "f1_scores": z,
            "evaluation_mode": mode,
        }

    accuracies = _fractions_within(reconstruction, scan, tolerances, device)
    if scan_completeness.shape[0] == 0:
        warnings.warn(
            "visibility mask eliminated every scan sample; completeness "
            "set to 0 (accuracy computed from the full scan)",
            RuntimeWarning,
        )
        completenesses = [0.0] * len(tolerances)
    else:
        completenesses = _fractions_within(scan_completeness, reconstruction, tolerances, device)
    f1s = [
        2 * a * c / (a + c) if (a + c) > 0 else 0.0
        for a, c in zip(accuracies, completenesses)
    ]
    return {
        "tolerances": list(tolerances),
        "accuracies": accuracies,
        "completenesses": completenesses,
        "f1_scores": f1s,
        "evaluation_mode": mode,
    }


def evaluate_ply(
    reconstruction_ply: str,
    ground_truth: str,
    tolerances: Sequence[float] = ETH3D_TOLERANCES,
    surface_spacing: float = SURFACE_SPACING,
    gt_model_path: str = None,
    visibility_min_views: int = 1,
    device="cuda",
    spans=None,
) -> Dict[str, List[float]]:
    """Evaluate a reconstruction PLY against a scan (.mlp or .ply).

    With ``gt_model_path`` (a COLMAP ground-truth calibration directory),
    completeness counts only scan samples visible in at least
    ``visibility_min_views`` views, and the mode gains "+visibility".
    ``spans`` (a ``utils.timing.Spans``): times the ``scan`` loading and
    sampling, the ``visibility`` mask and the ``nn`` distances."""
    from ..utils.timing import Spans

    spans = spans if spans is not None else Spans()
    rec = read_ply_xyz(reconstruction_ply)
    with spans.span("scan"):
        scan, mode = _load_scan_cached(ground_truth, surface_spacing)
    scan_completeness = None
    if gt_model_path is not None and os.path.isdir(gt_model_path):
        with spans.span("visibility"):
            scan_completeness = _visible_scan_cached(
                scan, ground_truth, gt_model_path, visibility_min_views, device
            )
        mode = mode + "+visibility"
    with spans.span("nn"):
        return evaluate_point_cloud(
            rec, scan, tolerances, mode=mode, scan_completeness=scan_completeness, device=device
        )


#: One-entry cache of the sampled scan keyed by (path, mtime, spacing):
#: ref and raw are evaluated against the same ground truth.
_scan_cache: Dict[tuple, tuple] = {}


def _load_scan_cached(ground_truth: str, surface_spacing: float):
    key = (
        os.path.abspath(ground_truth),
        os.path.getmtime(ground_truth),
        surface_spacing,
    )
    hit = _scan_cache.get(key)
    if hit is not None:
        return hit
    # Disk cache of the samples beside the scan (f32; the first run's
    # samples are f64, as the JAX package's).
    disk = (
        f"{key[0]}.samples-{surface_spacing}.npz"
        if surface_spacing and not os.environ.get("LFR_NO_SCAN_CACHE")
        else None
    )
    if disk and os.path.exists(disk):
        try:
            with np.load(disk) as z:
                if float(z["mtime"]) == key[1]:
                    scan, mode = z["scan"], str(z["mode"])
                    _scan_cache.clear()
                    _scan_cache[key] = (scan, mode)
                    return scan, mode
        except (OSError, ValueError, KeyError):
            pass
    if ground_truth.endswith(".mlp"):
        scan, mode = load_mlp_scan(ground_truth, surface_spacing)
    else:
        xyz, faces = read_ply_mesh(ground_truth)
        if faces is not None and surface_spacing:
            scan, mode = sample_mesh_surface(xyz, faces, surface_spacing), "surface"
        else:
            scan, mode = xyz, "vertex"
    if disk and mode == "surface":
        try:
            tmp = disk + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez(fh, scan=scan.astype(np.float32), mode=mode, mtime=key[1])
            os.replace(tmp, disk)
        except OSError:
            pass
    _scan_cache.clear()
    _scan_cache[key] = (scan, mode)
    return scan, mode


def format_results(results: Dict[str, List[float]]) -> str:
    """ETH3DMultiViewEvaluation-style text block (``<m>-<d>-{ref,raw}.txt``),
    with a trailing line naming the evaluation mode."""
    lines = [
        "Tolerances: " + ", ".join(str(t) for t in results["tolerances"]),
        "Accuracies: " + " ".join(f"{a:.6f}" for a in results["accuracies"]),
        "Completenesses: " + " ".join(f"{c:.6f}" for c in results["completenesses"]),
        "F1-scores: " + " ".join(f"{f:.6f}" for f in results["f1_scores"]),
        "Evaluation-mode: " + results.get("evaluation_mode", "vertex"),
    ]
    return "\n".join(lines) + "\n"
