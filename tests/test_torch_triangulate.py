"""The port's fixed-pose triangulation (lfr_tpu_torch.sfm.triangulate)
against lfr_tpu.sfm.triangulate on the same inputs.

Tolerances: tracks are equal arrays (the union-find is a copy).  Both
packages triangulate in float32; the packed device rows agree at 1e-4
relative (points: 1e-4 of their distance from the origin, about the depth
here; depths 1e-4 relative; angles 1e-5 rad).  A reprojection residual is
a float32 difference of two numbers ~1e3 times larger, so it is held
absolutely: RESIDUAL_ATOL in normalized units (2.5e-3 px at f = 500), where
the JAX function itself moves by 1.1e-6 when its observations move by one
ulp (the port reads 1.9e-6 from JAX).  Models keep the same point ids with
the same tracks, xyz within 1e-4 of the depth and mean reprojection errors
within 1e-4 px.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.io import colmap_db as jax_db
from lfr_tpu.sfm import triangulate as jax_triangulate
from lfr_tpu.utils import synthetic as jax_synthetic
from lfr_tpu_torch.io import colmap_db, colmap_model
from lfr_tpu_torch.sfm import triangulate

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_sfm import _scene_to_db_and_model  # noqa: E402

XYZ_RTOL = 1e-4
ERROR_ATOL_PX = 1e-4
RESIDUAL_ATOL = 5e-6


@pytest.fixture(scope="module")
def scene():
    return jax_synthetic.random_scene(np.random.default_rng(0), num_points=150, num_cameras=4)


def _port_model(model):
    """The JAX package's (empty) model as the port's classes."""
    return colmap_model.Model(
        cameras={k: colmap_model.Camera(c.camera_id, c.model, c.width, c.height, c.params)
                 for k, c in model.cameras.items()},
        images={k: colmap_model.Image(i.image_id, i.qvec, i.tvec, i.camera_id, i.name)
                for k, i in model.images.items()},
    )


def _both(scene, tmp_path, **kwargs):
    db, empty = _scene_to_db_and_model(scene, tmp_path, **kwargs)
    want = jax_triangulate.triangulate_model(db, empty)
    port_db = colmap_db.ColmapDatabase(str(tmp_path / "db.db"))
    got = triangulate.triangulate_model(port_db, _port_model(empty), device="cpu")
    db.close()
    port_db.close()
    return got, want


@pytest.mark.parametrize("noisy", [False, True])
def test_triangulate_model_matches_jax(scene, tmp_path, noisy):
    kwargs = dict(noise=0.5, outlier_frac=0.1, seed=3) if noisy else {}
    got, want = _both(scene, tmp_path, **kwargs)
    assert got.stats.keys() == want.stats.keys()
    for k in ("num_reg_images", "num_sparse_points", "num_observations"):
        assert got.stats[k] == want.stats[k]
    assert got.stats["mean_reproj_error"] == pytest.approx(want.stats["mean_reproj_error"],
                                                           abs=ERROR_ATOL_PX)
    assert list(got.model.points3D) == list(want.model.points3D)
    for pid, p in want.model.points3D.items():
        q = got.model.points3D[pid]
        np.testing.assert_array_equal(q.image_ids, p.image_ids)
        np.testing.assert_array_equal(q.point2D_idxs, p.point2D_idxs)
        assert np.abs(q.xyz - p.xyz).max() <= XYZ_RTOL * np.linalg.norm(p.xyz)
        assert abs(q.error - p.error) <= ERROR_ATOL_PX
    for iid, im in want.model.images.items():
        np.testing.assert_array_equal(got.model.images[iid].point3D_ids, im.point3D_ids)
        np.testing.assert_array_equal(got.model.images[iid].xys, im.xys)
    assert got.num_tracks >= got.stats["num_sparse_points"]
    if noisy:
        errs = [np.linalg.norm(p.xyz - scene.points[p.point2D_idxs[0]])
                for p in got.model.points3D.values()]
        assert np.median(errs) < 0.05


def test_feature_tracks_equal(scene, tmp_path):
    db, _ = _scene_to_db_and_model(scene, tmp_path, noise=0.5, outlier_frac=0.3, seed=4)
    num_features = {iid: db.keypoints(iid).shape[0] for iid in db.image_ids().values()}
    pairs = [(a, b, m) for a, b, m, _ in db.all_two_view_geometries() if m.shape[0]]
    want = jax_triangulate.build_feature_tracks(num_features, pairs)
    got = triangulate.build_feature_tracks(num_features, pairs)
    db.close()
    assert len(got) == len(want) > 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # Conflicting merges were rejected: at most one feature per image.
    assert all(len(set(t[:, 0].tolist())) == len(t) for t in got)


@pytest.mark.parametrize("iterations", [0, triangulate.GN_ITERATIONS])
def test_packed_rows_match_jax(scene, iterations):
    """One bucket of 8 observations with masked rows, noisy observations and
    a few tracks on identity cameras (JAX's padding rows)."""
    rng = np.random.default_rng(5)
    T, V = 150, 8
    P = np.zeros((T, V, 3, 4))
    uv = np.zeros((T, V, 2))
    ctr = np.zeros((T, V, 3))
    mask = np.zeros((T, V), bool)
    for k in range(T):
        cams = rng.permutation(4)[: rng.integers(2, 5)]
        for v, c in enumerate(cams):
            R, t = scene.rotations[c], scene.translations[c]
            P[k, v] = np.concatenate([R, t[:, None]], 1)
            x = R @ scene.points[k] + t
            uv[k, v] = x[:2] / x[2] + rng.normal(0, 1e-3, 2)
            ctr[k, v] = -R.T @ t
            mask[k, v] = True
    P[-3:] = 0.0
    P[-3:, :, :, :3] = np.eye(3)
    mask[-3:] = False
    mask[-3:, 0] = True
    args32 = [P.astype(np.float32), uv.astype(np.float32), mask, ctr.astype(np.float32)]
    want = np.asarray(jax_triangulate._triangulate_and_refine(
        *map(jnp.asarray, args32), iterations=iterations))
    got = triangulate._triangulate_and_refine(
        *[torch.from_numpy(a) for a in args32], iterations).numpy()
    assert got.shape == want.shape == (T, 4 + 2 * V) and got.dtype == np.float32
    scale = np.linalg.norm(want[:, :3], axis=1, keepdims=True)
    assert (np.abs(got[:-3, :3] - want[:-3, :3]) <= XYZ_RTOL * scale[:-3]).all()
    np.testing.assert_allclose(got[:-3, 3], want[:-3, 3], atol=1e-5)
    np.testing.assert_allclose(np.sqrt(got[:-3, 4 : 4 + V]), np.sqrt(want[:-3, 4 : 4 + V]),
                               rtol=0, atol=RESIDUAL_ATOL)
    np.testing.assert_allclose(got[:-3, 4 + V :], want[:-3, 4 + V :], rtol=1e-4, atol=1e-6)


def test_gn_improves_on_dlt_and_gates_reject(scene, tmp_path):
    """GN lowers the mean reprojection error of the noisy scene, and the
    angle gate drops every point when set above the rig's angles."""
    db, empty = _scene_to_db_and_model(scene, tmp_path, noise=0.5, seed=6)
    port_db = colmap_db.ColmapDatabase(str(tmp_path / "db.db"))
    model = _port_model(empty)
    gn = triangulate.triangulate_model(port_db, model, device="cpu")
    dlt = triangulate.triangulate_model(port_db, model, device="cpu", iterations=0)
    assert gn.stats["mean_reproj_error"] < dlt.stats["mean_reproj_error"]
    none = triangulate.triangulate_model(port_db, model, device="cpu", min_tri_angle_deg=90.0)
    assert none.stats["num_sparse_points"] == 0
    db.close()
    port_db.close()


def test_cuda_device_raises_without_a_card(monkeypatch, scene, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db, empty = _scene_to_db_and_model(scene, tmp_path)
    port_db = colmap_db.ColmapDatabase(str(tmp_path / "db.db"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        triangulate.triangulate_model(port_db, _port_model(empty))
    db.close()
    port_db.close()
    assert isinstance(jax_db.ColmapDatabase, type)
