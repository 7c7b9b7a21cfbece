"""The port's fixed-pose triangulation pipeline
(lfr_tpu_torch.pipelines.triangulation) against lfr_tpu's, raw and ref, on
a make_eth3d_dataset scene with a MatchingFile of its shared points (10%
rewired) and a planted SolutionFile.

Both packages get copies of one dataset.  The keypoints and putative
matches they write into the database must be equal bit for bit, and every
pair's configuration equal.  The two verify with different samplers
(jax.random against a torch generator; tests/test_torch_verify.py), so
inlier sets and the model may differ where a match's error lies near a
threshold: inlier sets by at most SAMPLER_DIFFER_SHARE of the putative
matches, point and observation counts by at most that share, and the mean
reprojection error by at most MEAN_ERROR_RTOL.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from lfr_tpu.io import colmap_db as jax_db
from lfr_tpu.pipelines import triangulation as jax_triangulation
from lfr_tpu_torch.io import colmap_db, colmap_model, features, protos
from lfr_tpu_torch.pipelines import import_features, triangulation
from lfr_tpu_torch.utils import synthetic

SAMPLER_DIFFER_SHARE = 0.02
MEAN_ERROR_RTOL = 0.02


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 4-camera ETH3D-layout scene with 0.5 px keypoint noise, its
    matches.pb (shared visible points, 10% rewired) and solution.pb
    (displacements to the true projections plus 0.1 px)."""
    root = str(tmp_path_factory.mktemp("eth3d") / "scene")
    rng = np.random.default_rng(0)
    scene = synthetic.random_scene(rng, num_points=160, num_cameras=4)
    synthetic.make_eth3d_dataset(root, scene, rng, keypoint_noise_px=0.5)
    names = [f"im{c:04d}.png" for c in range(scene.num_cameras)]
    pairs, solutions = [], []
    for c, name in enumerate(names):
        kp = features.load_features(os.path.join(root, "images", name), "sift").keypoints
        noisy = kp[:, :2] + 0.5
        target = scene.observations[c] + rng.normal(0, 0.1, noisy.shape)
        shift = ((target - noisy) / 16.0)[:, ::-1].astype(np.float32)
        solutions.append(protos.ImageSolution(
            name, 1.0, np.arange(len(kp), dtype=np.uint32), shift))
        for d in range(c + 1, len(names)):
            shared = np.nonzero(scene.visible[c] & scene.visible[d])[0]
            m = np.stack([shared, shared], 1)
            rows = rng.choice(len(m), len(m) // 10, replace=False)
            m[rows, 1] = rng.integers(0, scene.points.shape[0], len(rows))
            zeros = np.zeros((len(m), 3, 3, 2), np.float32)
            pairs.append(protos.PairMatches(name, 1.0, names[d], 1.0, m.astype(np.uint32),
                                            np.ones(len(m), np.float32), zeros, zeros))
    protos.write_matching_file(os.path.join(root, "matches.pb"), pairs)
    protos.write_solution_file(os.path.join(root, "solution.pb"), solutions)
    return root


def _copy(dataset, tmp_path, name):
    out = str(tmp_path / name)
    shutil.copytree(dataset, out)
    return out


def _files(root):
    return os.path.join(root, "matches.pb"), os.path.join(root, "solution.pb")


def _tables(path):
    db = colmap_db.ColmapDatabase(path)
    q = db.connection.execute
    out = {
        "keypoints": q("SELECT image_id, rows, cols, data FROM keypoints ORDER BY image_id;")
        .fetchall(),
        "matches": q("SELECT * FROM matches ORDER BY pair_id;").fetchall(),
        "tvg": {(a, b): (c, {tuple(r) for r in m.tolist()})
                for a, b, m, c in db.all_two_view_geometries()},
    }
    db.close()
    return out


@pytest.mark.parametrize("refined", [False, True])
def test_pipeline_matches_jax(dataset, tmp_path, refined):
    port_root, jax_root = _copy(dataset, tmp_path, "port"), _copy(dataset, tmp_path, "jax")
    matches, solution = _files(dataset)
    solution = solution if refined else None
    got = triangulation.triangulation_pipeline(port_root, "sift", matches, solution,
                                               verbose=False, device="cpu")
    want = jax_triangulation.triangulation_pipeline(jax_root, "sift", matches, solution,
                                                    verbose=False)
    tag = "ref" if refined else "raw"
    port_db, jax_tables = (_tables(os.path.join(r, f"sift-{tag}.db"))
                           for r in (port_root, jax_root))
    assert port_db["keypoints"] == jax_tables["keypoints"]
    assert port_db["matches"] == jax_tables["matches"]
    assert port_db["tvg"].keys() == jax_tables["tvg"].keys()
    n_putative = sum(r[1] for r in port_db["matches"])
    differ = 0
    for pair, (config, inliers) in jax_tables["tvg"].items():
        assert port_db["tvg"][pair][0] == config, pair
        differ += len(port_db["tvg"][pair][1] ^ inliers)
    assert differ <= SAMPLER_DIFFER_SHARE * n_putative

    for key in ("num_images", "num_inlier_pairs", "avg_num_features"):
        assert got["matching"][key] == want["matching"][key]
    g, w = got["triangulation"], want["triangulation"]
    assert g.keys() == w.keys()
    assert g["num_reg_images"] == w["num_reg_images"] == 4
    for key in ("num_sparse_points", "num_observations"):
        assert abs(g[key] - w[key]) <= SAMPLER_DIFFER_SHARE * w[key], key
    assert g["mean_reproj_error"] == pytest.approx(w["mean_reproj_error"], rel=MEAN_ERROR_RTOL)
    assert g["mean_reproj_error"] < (0.2 if refined else 1.0)
    spans = {s["span"] for s in got["timing"]}
    assert {"import_verify/keypoints", "import_verify/matches", "import_verify/verify",
            "import_verify", "triangulate/tracks", "triangulate/pack", "triangulate/device",
            "triangulate/gate", "triangulate", "write_model"} <= spans
    assert got["num_tracks"] >= g["num_sparse_points"]
    model = colmap_model.read_model(os.path.join(port_root, f"sparse-sift-{tag}"))
    assert len(model.points3D) == g["num_sparse_points"]
    xyz = colmap_model.read_ply_xyz(os.path.join(port_root, f"sparse-sift-{tag}.ply"))
    assert xyz.shape == (g["num_sparse_points"], 3)


def test_cli_writes_what_the_function_writes(dataset, tmp_path):
    fn_root, cli_root = _copy(dataset, tmp_path, "fn"), _copy(dataset, tmp_path, "cli")
    matches, solution = _files(dataset)
    triangulation.triangulation_pipeline(fn_root, "sift", matches, solution, verbose=False,
                                         device="cpu")
    triangulation.main(["--dataset_path", cli_root, "--method_name", "sift", "--matches_file",
                        matches, "--solution_file", solution, "--device", "cpu"])
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(fn_root, "sparse-sift-ref", name), "rb") as a, open(
                os.path.join(cli_root, "sparse-sift-ref", name), "rb") as b:
            assert a.read() == b.read(), name
    assert _tables(os.path.join(fn_root, "sift-ref.db")) == _tables(
        os.path.join(cli_root, "sift-ref.db"))
    with pytest.raises(FileExistsError):
        triangulation.triangulation_pipeline(fn_root, "sift", matches, solution, verbose=False,
                                             device="cpu")


def test_apply_solution_matches_jax():
    from lfr_tpu.io import protos as jax_protos
    from lfr_tpu.pipelines import import_features as jax_import

    rng = np.random.default_rng(1)
    kp = rng.uniform(0, 600, (20, 4)).astype(np.float32)
    idx = np.array([1, 4, 7, 19], np.uint32)
    disp = rng.normal(0, 0.1, (4, 2)).astype(np.float32)
    port = protos.ImageSolution("a", 3.78, idx, disp)
    ref = jax_protos.ImageSolution("a", 3.78, idx, disp)
    np.testing.assert_array_equal(import_features.apply_solution(kp, port),
                                  jax_import.apply_solution(kp, ref))
    np.testing.assert_array_equal(import_features.apply_solution(kp, None),
                                  jax_import.apply_solution(kp, None))


def test_cuda_device_raises_without_a_card(monkeypatch, dataset, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = _copy(dataset, tmp_path, "nocard")
    matches, solution = _files(dataset)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        triangulation.triangulation_pipeline(root, "sift", matches, solution, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import_features.import_features("sift", os.path.join(root, "database.db"),
                                        os.path.join(root, "images"), matches)
    assert not os.path.exists(os.path.join(root, "sift-ref.db"))
    assert isinstance(jax_db.ColmapDatabase, type)
