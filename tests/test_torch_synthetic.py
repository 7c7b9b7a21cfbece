"""The port's numpy copy of the synthetic data against lfr_tpu's: the same
seed must give the same arrays, bit for bit."""

import pathlib
import sys

import numpy as np
import pytest

from lfr_tpu.utils import synthetic as jax_synthetic
from lfr_tpu_torch.utils import synthetic


@pytest.mark.parametrize(
    "name, args",
    [
        ("textured_image", (50, 70)),
        ("shifted_pair", (40, 56, (2, -3))),
        ("planted_features", (17, 60, 80)),
    ],
)
def test_generators_match_jax_package(name, args):
    got = getattr(synthetic, name)(np.random.default_rng(5), *args)
    want = getattr(jax_synthetic, name)(np.random.default_rng(5), *args)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_bench_workload_is_bench_py_workload():
    """bench.py builds its 2048-match workload from lfr_tpu.utils.synthetic."""
    image1, image2, kps1, kps2, matches = synthetic.bench_workload(np.random.default_rng(0))
    rng = np.random.default_rng(0)
    want1, want2 = jax_synthetic.shifted_pair(rng, 480, 640, (3, -2))
    want_kps1, _ = jax_synthetic.planted_features(rng, 2048, 480, 640)
    np.testing.assert_array_equal(image1, want1)
    np.testing.assert_array_equal(image2, want2)
    np.testing.assert_array_equal(kps1, want_kps1)
    np.testing.assert_array_equal(kps2, want_kps1 + np.array([2.0, -3.0]))
    np.testing.assert_array_equal(matches, np.stack([np.arange(2048)] * 2, axis=1))


def test_match_graph_workload_writes_a_consistent_scene(tmp_path):
    from lfr_tpu_torch.io import features, match_list, png

    truth = synthetic.match_graph_workload(np.random.default_rng(4), str(tmp_path), num_views=3,
                                           height=100, width=120, points_per_view=9)
    names = truth["images"]
    assert match_list.read_match_list(truth["match_list"]) == match_list.exhaustive_pairs(names)
    assert (truth["offsets"] % 5 == 0).all()
    views, canvas_xy = [], {}
    for name, ids, (oy, ox) in zip(names, truth["point_ids"], truth["offsets"]):
        with open(tmp_path / name, "rb") as fh:
            image = png.decode_png(fh.read())
        assert image.shape == (100, 120, 3) and image.dtype == np.uint8
        views.append((image, oy, ox))
        feats = features.load_features(str(tmp_path / name), "sift")
        assert feats.keypoints.shape == (9, 2) and len(set(ids)) == 9
        np.testing.assert_allclose(np.linalg.norm(feats.descriptors, axis=1), 1.0, atol=1e-6)
        for pid, xy in zip(ids, feats.keypoints + [ox, oy]):
            # Every view sees a canvas point at one canvas position.
            np.testing.assert_allclose(canvas_xy.setdefault(pid, xy), xy, atol=1e-9)
    with pytest.raises(ValueError, match="share no area"):
        synthetic.match_graph_workload(np.random.default_rng(4), str(tmp_path), height=40,
                                       width=56)
    # The views are crops of one canvas: equal where they overlap.
    (a, ay, ax), (b, by, bx) = views[0], views[1]
    y0, x0 = max(ay, by), max(ax, bx)
    y1, x1 = min(ay, by) + 100, min(ax, bx) + 120
    np.testing.assert_array_equal(a[y0 - ay : y1 - ay, x0 - ax : x1 - ax],
                                  b[y0 - by : y1 - by, x0 - bx : x1 - bx])


@pytest.mark.parametrize("n_images, n_points, visibility", [(12, 300, 0.5), (5, 40, 0.9)])
def test_solver_graph_is_bench_solver_graph(n_images, n_points, visibility):
    """Without outliers, solver_graph is scripts/bench_solver.py's
    synth_match_graph, array for array, and leaves the rng where it does."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))
    from bench_solver import synth_match_graph

    rng_got, rng_want = np.random.default_rng(3), np.random.default_rng(3)
    got = synthetic.solver_graph(rng_got, n_images, n_points, visibility)
    want = synth_match_graph(rng_want, n_images, n_points, visibility)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.image_name1, g.fact1, g.image_name2, g.fact2) == (
            w.image_name1, w.fact1, w.image_name2, w.fact2)
        for field in ("matches", "similarities", "disp1", "disp2"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    assert rng_got.random() == rng_want.random()


def test_solver_graph_rewires_the_outlier_share():
    clean = synthetic.solver_graph(np.random.default_rng(4), 6, 200)
    noisy = synthetic.solver_graph(np.random.default_rng(4), 6, 200, outlier_share=0.05)
    for c, n in zip(clean, noisy):
        np.testing.assert_array_equal(n.matches[:, 0], c.matches[:, 0])
        np.testing.assert_array_equal(n.disp2, c.disp2)
        rewired = n.matches[:, 1] != c.matches[:, 1]
        # Rows are drawn without replacement; a draw may land on its own point.
        assert rewired.sum() <= round(0.05 * c.num_matches)
        assert rewired.sum() >= round(0.05 * c.num_matches) - 2
        assert n.matches[:, 1].max() < 200


def test_random_scene_matches_jax_package():
    rng_got, rng_want = np.random.default_rng(6), np.random.default_rng(6)
    got = synthetic.random_scene(rng_got, num_points=50, num_cameras=3, noise_px=0.5)
    want = jax_synthetic.random_scene(rng_want, num_points=50, num_cameras=3, noise_px=0.5)
    for field in ("points", "rotations", "translations", "K", "width", "height"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    for field in ("observations", "visible"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_array_equal(a, b)
    assert got.num_cameras == 3 and rng_got.random() == rng_want.random()


def test_make_eth3d_dataset_matches_jax_package(tmp_path):
    """The same files (the PNG images: the same pixels) from the same seed."""
    import cv2
    from lfr_tpu_torch.io import features, png

    scene = synthetic.random_scene(np.random.default_rng(7), num_points=30, num_cameras=3)
    synthetic.make_eth3d_dataset(str(tmp_path / "port"), scene, np.random.default_rng(8),
                                 keypoint_noise_px=0.5)
    jax_synthetic.make_eth3d_dataset(str(tmp_path / "jax"), scene, np.random.default_rng(8),
                                     keypoint_noise_px=0.5)
    for rel in ("dslr_calibration_undistorted/cameras.txt",
                "dslr_calibration_undistorted/images.txt",
                "dslr_calibration_undistorted/points3D.txt", "match-list.txt",
                "dslr_scan_eval/scan.ply", "dslr_scan_eval/scan_alignment.mlp"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    for c in range(3):
        name = f"im{c:04d}.png"
        got = features.load_features(str(tmp_path / "port" / "images" / name), "sift")
        want = features.load_features(str(tmp_path / "jax" / "images" / name), "sift")
        np.testing.assert_array_equal(got.keypoints, want.keypoints)
        np.testing.assert_array_equal(got.descriptors, want.descriptors)
        pixels = png.decode_png((tmp_path / "port" / "images" / name).read_bytes())
        np.testing.assert_array_equal(
            pixels, cv2.imread(str(tmp_path / "jax" / "images" / name))[:, :, ::-1])
    import sqlite3

    dumps = [list(sqlite3.connect(str(tmp_path / p / "database.db")).iterdump())
             for p in ("port", "jax")]
    assert dumps[0] == dumps[1]


def test_triangulation_workload_is_consistent(tmp_path):
    from lfr_tpu_torch.io import colmap_db, colmap_model, features, protos
    from lfr_tpu_torch.pipelines.import_features import apply_solution

    truth = synthetic.triangulation_workload(np.random.default_rng(9), str(tmp_path), 8, 400)
    names = truth["names"]
    model = colmap_model.read_model(str(tmp_path / "dslr_calibration_undistorted"))
    cam = model.cameras[1]
    assert (cam.model, cam.width, cam.height) == ("PINHOLE", 6048, 4032)
    db = colmap_db.ColmapDatabase(str(tmp_path / "database.db"))
    assert sorted(db.image_ids()) == names
    db.close()
    solutions = {s.image_name: s for s in protos.read_solution_file(truth["solution_file"])}
    by_name = model.image_by_name()
    seen = np.zeros(400, int)
    for name, ids in zip(names, truth["point_of_feature"]):
        im = by_name[name]
        R = colmap_model.qvec_to_rotmat(im.qvec)
        cam_pts = truth["points"][ids] @ R.T + im.tvec
        uv = cam_pts[:, :2] / cam_pts[:, 2:] * 3400.0 + [3024.0, 2016.0]
        kp = features.load_features(str(tmp_path / "images" / name), "sift")
        kp = kp.completed_keypoints().astype(np.float32)
        raw = apply_solution(kp, None)[:, :2] - uv
        ref = apply_solution(kp, solutions[name])[:, :2] - uv
        # 0.5 px noise, planted down to 0.1 px (per coordinate).
        assert 0.4 < raw.std() < 0.6 and 0.07 < ref.std() < 0.13
        seen[ids] += 1
    assert 2 <= seen.min() and seen.max() <= 8
    pairs = protos.read_matching_file(truth["matches_file"])
    assert len(pairs) == 28 and pairs[0].fact1 == pytest.approx(6048 / 1600)
    n_rewired = n_matches = 0
    for p in pairs:
        a, b = names.index(p.image_name1), names.index(p.image_name2)
        pof = truth["point_of_feature"]
        wrong = pof[a][p.matches[:, 0]] != pof[b][p.matches[:, 1]]
        rewired = truth["rewired"][(p.image_name1, p.image_name2)]
        assert len(rewired) == round(0.1 * p.num_matches)
        assert wrong.sum() <= len(rewired)
        n_rewired += len(rewired)
        n_matches += p.num_matches
    assert 0.09 < n_rewired / n_matches < 0.11
