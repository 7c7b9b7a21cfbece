"""Synthetic images, keypoints and scenes for the port's tests and chip
smoke run.

A numpy-only copy of ``textured_image``, ``shifted_pair``,
``planted_features``, ``Scene``, ``random_scene`` and ``make_eth3d_dataset``
from lfr_tpu.utils.synthetic: the same seed gives the same arrays in both
packages.  :func:`bench_workload` is bench.py's two-view workload,
:func:`match_graph_workload` writes a scene of PNG images and feature files
for the match graph, :func:`solver_graph` is a match graph for the
multi-view solver, and :func:`triangulation_workload` writes an ETH3D-layout
scene with its MatchingFile and SolutionFile for the triangulation chain.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

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


# ---------------------------------------------------------------------------
# Full 3D scenes for the triangulation chain
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Scene:
    points: np.ndarray            # (P, 3) world points
    rotations: np.ndarray         # (C, 3, 3) world->cam
    translations: np.ndarray      # (C, 3)
    K: np.ndarray                 # (3, 3) shared intrinsics
    width: int
    height: int
    observations: List[np.ndarray]  # per camera: (P, 2) pixel coords
    visible: List[np.ndarray]       # per camera: (P,) bool

    @property
    def num_cameras(self) -> int:
        return self.rotations.shape[0]


def random_scene(
    rng: np.random.Generator,
    num_points: int = 200,
    num_cameras: int = 4,
    width: int = 640,
    height: int = 480,
    noise_px: float = 0.0,
    arc_step: float = 0.15,
) -> Scene:
    """Cameras on an arc looking at a point cloud near the origin.

    ``arc_step``: angular spacing (rad) between cameras — shrink it for
    many-camera rigs so the far ends of the arc still see the cloud.
    """
    points = rng.uniform(-1.0, 1.0, (num_points, 3))
    points[:, 2] += 6.0

    f = 500.0
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])

    rotations, translations, observations, visible = [], [], [], []
    for c in range(num_cameras):
        angle = (c - (num_cameras - 1) / 2) * arc_step
        Ry = np.array(
            [
                [np.cos(angle), 0, np.sin(angle)],
                [0, 1, 0],
                [-np.sin(angle), 0, np.cos(angle)],
            ]
        )
        center = np.array([2.5 * np.sin(angle), 0.2 * c * (arc_step / 0.15), 6.0 - 6.0 * np.cos(angle)])
        R = Ry
        t = -R @ center
        cam_pts = points @ R.T + t
        uv = (cam_pts / cam_pts[:, 2:]) @ K.T
        uv = uv[:, :2]
        if noise_px > 0:
            uv = uv + rng.normal(0, noise_px, uv.shape)
        vis = (
            (cam_pts[:, 2] > 0.2)
            & (uv[:, 0] > 2)
            & (uv[:, 0] < width - 2)
            & (uv[:, 1] > 2)
            & (uv[:, 1] < height - 2)
        )
        rotations.append(R)
        translations.append(t)
        observations.append(uv)
        visible.append(vis)

    return Scene(
        points=points,
        rotations=np.stack(rotations),
        translations=np.stack(translations),
        K=K,
        width=width,
        height=height,
        observations=observations,
        visible=visible,
    )


def _write_scan(root: str, scan_ply) -> None:
    """dslr_scan_eval/: the scan PLY (written by ``scan_ply(path)``) and an
    identity scan_alignment.mlp."""
    scan_ply(os.path.join(root, "dslr_scan_eval", "scan.ply"))
    with open(os.path.join(root, "dslr_scan_eval", "scan_alignment.mlp"), "w") as fh:
        fh.write(
            '<!DOCTYPE MeshLabDocument>\n<MeshLabProject>\n <MeshGroup>\n'
            '  <MLMesh filename="scan.ply" label="scan">\n'
            "   <MLMatrix44>\n1 0 0 0 \n0 1 0 0 \n0 0 1 0 \n0 0 0 1 \n</MLMatrix44>\n"
            "  </MLMesh>\n </MeshGroup>\n</MeshLabProject>\n"
        )


def _points_ply(points: np.ndarray):
    from ..io import colmap_model

    scan_pts = {
        i + 1: colmap_model.Point3D(
            i + 1, points[i], np.full(3, 200, np.uint8), 0.0,
            np.zeros(0, np.int64), np.zeros(0, np.int64),
        )
        for i in range(points.shape[0])
    }
    return lambda path: colmap_model.write_ply(path, scan_pts)


def _eth3d_cameras(root: str, K: np.ndarray, width: int, height: int):
    """database.db with one PINHOLE camera and the ground-truth model's
    camera: returns (open database, camera id, empty ground-truth model)."""
    from ..io import colmap_db, colmap_model

    params = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    db = colmap_db.ColmapDatabase.create(os.path.join(root, "database.db"))
    cam_id = db.add_camera(1, width, height, params)
    gt = colmap_model.Model()
    gt.cameras[cam_id] = colmap_model.Camera(cam_id, "PINHOLE", width, height, params)
    return db, cam_id, gt


def make_eth3d_dataset(
    root: str,
    scene: Scene,
    rng: np.random.Generator,
    method: str = "sift",
    keypoint_noise_px: float = 0.0,
    descriptor_dim: int = 128,
    rendered_images: "List[np.ndarray]" = None,
    scan_mesh: "Tuple[np.ndarray, np.ndarray]" = None,
) -> str:
    """Materialize an ETH3D-layout dataset from a synthetic scene.

    Layout (reference: eth/benchmark.py:81-91, triangulation_pipeline.py):
      images/ + per-image ``<name>.<method>`` npz features,
      database.db (cameras + images only),
      dslr_calibration_undistorted/ (ground-truth model, no points),
      dslr_scan_eval/scan_alignment.mlp (+ scan ply),
      match-list.txt (exhaustive).

    Feature index == scene point index in every image; descriptors are
    per-point unit vectors plus per-image noise so MNN matching recovers
    ground-truth correspondences.  Images are PNG, written with the port's
    own encoder (the same pixels as the JAX package's).
    """
    from ..io import colmap_model, features, match_list
    from ..io.png import encode_png

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "dslr_scan_eval"), exist_ok=True)

    point_desc = rng.standard_normal((scene.points.shape[0], descriptor_dim)).astype(np.float32)
    point_desc /= np.linalg.norm(point_desc, axis=1, keepdims=True)

    db, cam_id, gt = _eth3d_cameras(root, scene.K, scene.width, scene.height)

    names = []
    for c in range(scene.num_cameras):
        name = f"im{c:04d}.png"
        names.append(name)
        img = (
            rendered_images[c]
            if rendered_images is not None
            else textured_image(rng, scene.height, scene.width)
        )
        with open(os.path.join(root, "images", name), "wb") as fh:
            fh.write(encode_png(img))
        iid = db.add_image(name, cam_id)
        gt.images[iid] = colmap_model.Image(
            iid,
            colmap_model.rotmat_to_qvec(scene.rotations[c]),
            scene.translations[c],
            cam_id,
            name,
        )
        obs = scene.observations[c].copy()
        if keypoint_noise_px:
            obs += rng.normal(0, keypoint_noise_px, obs.shape)
        # npz features use the -0.5 convention relative to COLMAP pixel
        # centers (reference: utils/extract_features_sift.py:93); the import
        # stage adds the 0.5 back.
        kp = np.hstack(
            [obs - 0.5, np.ones((obs.shape[0], 1)), np.zeros((obs.shape[0], 1))]
        )
        desc = point_desc + 0.05 * rng.standard_normal(point_desc.shape).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        # Hide invisible points' descriptors so they can't match.
        invis = ~scene.visible[c]
        desc[invis] = rng.standard_normal((int(invis.sum()), descriptor_dim))
        desc[invis] /= np.linalg.norm(desc[invis], axis=1, keepdims=True)
        features.save_features(
            os.path.join(root, "images", name), kp, desc, method_name=method
        )
    db.commit()
    db.close()

    colmap_model.write_model(os.path.join(root, "dslr_calibration_undistorted"), gt)
    match_list.write_match_list(
        os.path.join(root, "match-list.txt"), match_list.exhaustive_pairs(names)
    )

    # Ground-truth "scan": a triangulated surface mesh when the scene has
    # one (enables point-to-SURFACE evaluation), else the points.
    if scan_mesh is not None:
        _write_scan(root, lambda path: colmap_model.write_ply_mesh(path, *scan_mesh))
    else:
        _write_scan(root, _points_ply(scene.points))
    return root


#: ETH3D DSLR images: 6048x4032 px, undistorted PINHOLE focal about 3400 px.
ETH3D_DSLR = dict(width=6048, height=4032, focal=3400.0)


def triangulation_workload(
    rng: np.random.Generator,
    root: str,
    num_cameras: int = 30,
    num_points: int = 20000,
    method: str = "sift",
) -> dict:
    """Write an ETH3D-layout scene for the fixed-pose triangulation chain
    into ``root`` (README's 30-camera scene with the defaults).

    Cameras: ``num_cameras`` on a 90-degree arc of radius 6 around (0, 0, 6),
    all looking at that centre, each with the PINHOLE calibration of an
    ETH3D DSLR image (ETH3D_DSLR).  Points: uniform in a 3 x 2 x 2 box at
    the centre; each is seen by a run of 2-12 neighbouring cameras (length
    and start uniform; at most ``num_cameras``), so adjacent cameras share a few thousand points and
    cameras 12 or more apart none.  Each camera's keypoints are its points
    in a random order, projected with 0.5 px Gaussian noise per coordinate
    and stored in ``images/<name>.<method>`` (no image files: the chain
    reads features, the database and the model only).

    ``matches.pb`` holds a MatchingFile of every camera pair (exhaustive,
    empty pairs included) whose matches are the shared points, with 10% of
    each pair's rows (rounded) rewired to a random feature of image 2
    (zero flows, unit similarities, ``fact`` the sift downscale factor of
    the image).  ``solution.pb`` holds a planted SolutionFile: every
    feature's displacement takes its keypoint to the true projection plus
    0.1 px of fresh Gaussian noise per coordinate.  It is no solver's
    output: the solver's gauge makes a solved one no oracle here.

    Returns {"matches_file", "solution_file", "names", "points" (P, 3),
    "point_of_feature": per camera (F,) point ids, "rewired": {(name1,
    name2): (K, 2) rewired matches}}.
    """
    from ..config import DISPLACEMENT_UNIT_PX, downscale_factor, get_method
    from ..io import colmap_model, features, protos

    width, height, focal = ETH3D_DSLR["width"], ETH3D_DSLR["height"], ETH3D_DSLR["focal"]
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1.0]])
    cfg = get_method(method)
    fact = downscale_factor(height, width, cfg.max_edge, cfg.max_sum_edges)
    noise_px, residual_px, outlier_share = 0.5, 0.1, 0.1

    points = rng.uniform((-1.5, -1.0, -1.0), (1.5, 1.0, 1.0), (num_points, 3))
    points[:, 2] += 6.0
    length = rng.integers(2, min(12, num_cameras) + 1, num_points)
    start = rng.integers(0, num_cameras - length + 1)

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "dslr_scan_eval"), exist_ok=True)
    db, cam_id, gt = _eth3d_cameras(root, K, width, height)
    names, point_of_feature, feature_of_point, solutions = [], [], [], []
    for c, angle in enumerate(np.linspace(-np.pi / 4, np.pi / 4, num_cameras)):
        z_axis = np.array([-np.sin(angle), 0.0, np.cos(angle)])
        R = np.stack([np.array([np.cos(angle), 0.0, np.sin(angle)]), np.array([0.0, 1.0, 0.0]),
                      z_axis])
        t = -R @ (np.array([0.0, 0.0, 6.0]) - 6.0 * z_axis)
        seen = np.nonzero((start <= c) & (c < start + length))[0]
        ids = rng.permutation(seen)
        cam = points[ids] @ R.T + t
        uv = cam[:, :2] / cam[:, 2:] * focal + K[:2, 2]
        if not ((cam[:, 2] > 0) & (uv >= 0).all(1) & (uv < (width, height)).all(1)).all():
            raise ValueError("a point of a camera's run projects outside its image")
        noisy = uv + rng.normal(0.0, noise_px, uv.shape)
        target = uv + rng.normal(0.0, residual_px, uv.shape)
        name = f"dsc_{c:04d}.jpg"
        iid = db.add_image(name, cam_id)
        gt.images[iid] = colmap_model.Image(iid, colmap_model.rotmat_to_qvec(R), t, cam_id, name)
        # npz keypoints are 0.5 px left of COLMAP's pixel centres.
        features.save_features(
            os.path.join(root, "images", name),
            np.hstack([noisy - 0.5, np.ones((len(ids), 1)), np.zeros((len(ids), 1))]),
            np.zeros((len(ids), 1), np.float32),
            method_name=method,
        )
        # (dx, dy) px -> (di, dj) units at the downscaled resolution.
        shift = ((target - noisy) / (fact * DISPLACEMENT_UNIT_PX))[:, ::-1]
        solutions.append(protos.ImageSolution(
            name, fact, np.arange(len(ids), dtype=np.uint32), shift.astype(np.float32)))
        lookup = np.full(num_points, -1, np.int64)
        lookup[ids] = np.arange(len(ids))
        names.append(name)
        point_of_feature.append(ids)
        feature_of_point.append(lookup)
    db.commit()
    db.close()
    colmap_model.write_model(os.path.join(root, "dslr_calibration_undistorted"), gt)
    _write_scan(root, _points_ply(points))

    pairs, rewired = [], {}
    for a in range(num_cameras):
        for b in range(a + 1, num_cameras):
            shared = np.nonzero((feature_of_point[a] >= 0) & (feature_of_point[b] >= 0))[0]
            m = np.stack([feature_of_point[a][shared], feature_of_point[b][shared]], 1)
            k = int(round(outlier_share * len(m)))
            rows = rng.choice(len(m), k, replace=False)
            m[rows, 1] = rng.integers(0, len(point_of_feature[b]), k)
            rewired[(names[a], names[b])] = m[rows]
            n = len(m)
            zeros = np.zeros((n, 3, 3, 2), np.float32)
            pairs.append(protos.PairMatches(names[a], fact, names[b], fact, m.astype(np.uint32),
                                            np.ones(n, np.float32), zeros, zeros))
    matches_file = os.path.join(root, "matches.pb")
    solution_file = os.path.join(root, "solution.pb")
    protos.write_matching_file(matches_file, pairs)
    protos.write_solution_file(solution_file, solutions)
    return {"matches_file": matches_file, "solution_file": solution_file, "names": names,
            "points": points, "point_of_feature": point_of_feature, "rewired": rewired}
