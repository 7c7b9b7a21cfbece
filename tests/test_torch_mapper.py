"""The port's incremental mapper (lfr_tpu_torch.sfm.mapper) against
lfr_tpu.sfm.mapper on tests/test_mapper.py's scenes.

With JAX's own RANSAC samples injected through the mapper's sample source
(``jax.random.choice`` under PRNGKey(0) for F, PRNGKey(1) for H and
PRNGKey(0) for every PnP, as the JAX mapper draws them), the port must
register JAX's images in JAX's order, with every camera centre within
CENTER_BOUND of JAX's and as many points.  The bounds come from a control:
JAX's mapper against itself on the database with every keypoint scaled by
1 + 2e-7 N(0, 1) (seeds 1, 2, 3), which registered the same images in the
same order with the same point counts and moved a camera centre by at most
2.81e-4 (five-camera scene) and 3.91e-3 (planar scene), in scene units; the
bound is 4 times that (the port's float32 arithmetic rounds differently at
every step; it read 2.77e-4 and 1.79e-4).

The homography decomposition is numpy in the port (the card's machine has
no OpenCV) and must return ``cv2.decomposeHomographyMat``'s candidates in
its order, since the initializer keeps the first of tied candidates.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.sfm import mapper as jax_mapper
from lfr_tpu.utils import synthetic as jax_synthetic
from lfr_tpu_torch.io import colmap_db
from lfr_tpu_torch.sfm import mapper
from test_sfm import _scene_to_db_and_model

#: Largest camera-centre deviation from JAX (scene units): 4 x the control.
CENTER_BOUND = {"five": 4 * 2.81e-4, "planar": 4 * 3.91e-3}

#: Candidates of the decomposition against OpenCV's.
DECOMPOSITION_ATOL = 1e-6

_draw = jax.jit(
    lambda key, p, n, s: jax.random.choice(key, n, shape=(256, s), replace=True, p=p),
    static_argnums=(2, 3),
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of tiny torch ops,
    which the suite's parallel workers slow down by oversubscribing the
    cores; the thread count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxSamples:
    """The JAX mapper's sample indices, as a sample source of the port's."""

    def _draw(self, seed, n_valid, n_padded, size):
        valid = np.zeros(n_padded, bool)
        valid[:n_valid] = True
        probs = jnp.asarray(valid, jnp.float32) / n_valid
        return torch.from_numpy(np.array(_draw(jax.random.PRNGKey(seed), probs, n_padded, size)))

    def fundamental(self, n_valid, n_padded):
        return self._draw(0, n_valid, n_padded, 8)

    def homography(self, n_valid, n_padded):
        return self._draw(1, n_valid, n_padded, 4)

    def pnp(self, n_valid, n_padded):
        return self._draw(0, n_valid, n_padded, 6)


def _rotation(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _homographies():
    """tests/test_mapper.py:247's homography, then seeded ones (scaled
    arbitrarily, as the mapper's RANSAC returns them)."""
    rng = np.random.default_rng(4)
    n = np.array([0.1, -0.05, -1.0])
    yield _rotation(0.25 * rng.standard_normal(3)) + np.outer([0.4, -0.1, 0.2], n / np.linalg.norm(n))
    rng = np.random.default_rng(0)
    for _ in range(24):
        n = rng.normal(0, 1, 3)
        H = _rotation(0.3 * rng.standard_normal(3)) + np.outer(rng.normal(0, 0.5, 3), n / np.linalg.norm(n))
        yield H * rng.uniform(0.5, 2.0)


def test_decompose_homography_equals_opencv_in_order():
    for H in _homographies():
        Hn = H / np.linalg.svd(H, compute_uv=False)[1]
        _, Rs, ts, ns = cv2.decomposeHomographyMat(Hn, np.eye(3))
        got = mapper.decompose_homography(Hn)
        assert len(got[0]) == len(Rs) == 4
        for want, mine in zip((Rs, ts, ns), got):
            for w, g in zip(want, mine):
                np.testing.assert_allclose(g, np.asarray(w).reshape(np.shape(g)),
                                           rtol=0, atol=DECOMPOSITION_ATOL)
        # The mapper's candidate list (pure rotations dropped, t normalised).
        for (R0, t0), (R1, t1) in zip(jax_mapper.IncrementalMapper._decompose_homography(H),
                                      mapper.IncrementalMapper._decompose_homography(H)):
            np.testing.assert_allclose(R1, R0, atol=DECOMPOSITION_ATOL)
            np.testing.assert_allclose(t1, t0, atol=DECOMPOSITION_ATOL)
    # A rotation: OpenCV's single motion with t = 0, which the mapper drops.
    R = _rotation(np.array([0.1, 0.2, -0.1]))
    assert len(cv2.decomposeHomographyMat(R, np.eye(3))[1]) == 1
    assert len(mapper.decompose_homography(R)[0]) == 1
    assert mapper.IncrementalMapper._decompose_homography(R) == []


def _scene_db(kind, tmp_path):
    if kind == "five":  # tests/test_mapper.py:43
        rng = np.random.default_rng(2)
        scene = jax_synthetic.random_scene(rng, num_points=150, num_cameras=5, noise_px=0.3)
        db, _ = _scene_to_db_and_model(scene, tmp_path, noise=0.3, seed=5)
    else:  # tests/test_mapper.py:225
        rng = np.random.default_rng(11)
        scene = jax_synthetic.planar_scene(rng, num_points=150, num_cameras=5, depth_step=0.0)[0]
        db, _ = _scene_to_db_and_model(scene, tmp_path, noise=0.2, seed=3)
    return db, scene


@pytest.fixture(scope="module", params=["five", "planar"])
def jax_run(request, tmp_path_factory):
    """JAX's mapper on the scene's database, and the database's path."""
    tmp = tmp_path_factory.mktemp(request.param)
    db, scene = _scene_db(request.param, tmp)
    m = jax_mapper.IncrementalMapper(db)
    model = m.reconstruct(verbose=False)
    db.close()
    centers = {iid: -m.R[iid].T @ m.t[iid] for iid in m.registered}
    return request.param, str(tmp / "db.db"), list(m.registered), centers, len(model.points3D)


def test_mapper_with_jax_samples_follows_jax(jax_run):
    kind, path, registered, centers, n_points = jax_run
    db = colmap_db.ColmapDatabase(path)
    m = mapper.IncrementalMapper(db, device="cpu", samples=JaxSamples())
    model = m.reconstruct(verbose=False)
    db.close()
    assert m.registered == registered
    dev = max(np.abs(-m.R[i].T @ m.t[i] - centers[i]).max() for i in registered)
    assert dev <= CENTER_BOUND[kind], dev
    assert len(model.points3D) == n_points


def test_mapper_with_its_own_samples_reconstructs(jax_run):
    """The default sample source (the port's CPU generators) registers every
    image of both scenes, as JAX does."""
    kind, path, registered, _, n_points = jax_run
    db = colmap_db.ColmapDatabase(path)
    model, stats = mapper.reconstruct(db, verbose=False, device="cpu")
    db.close()
    assert sorted(model.images) == sorted(registered)
    assert stats["num_sparse_points"] >= 0.95 * n_points
    assert stats["mean_reproj_error"] < 1.0  # as tests/test_mapper.py
    assert stats["num_models"] == 1 and stats["selected_model"] == 0
    assert set(stats["phase_times"]) >= {"init", "global_ba", "local_ba", "pnp_register"}


def test_failed_init_leaves_no_partial_state(tmp_path):
    """tests/test_mapper.py:143 on the port: an init that fails after it
    created poses and points resets everything."""
    rng = np.random.default_rng(3)
    scene = jax_synthetic.random_scene(rng, num_points=150, num_cameras=4, noise_px=0.3)
    _scene_to_db_and_model(scene, tmp_path, noise=0.3, seed=7)[0].close()
    m = mapper.IncrementalMapper(colmap_db.ColmapDatabase(str(tmp_path / "db.db")), device="cpu")
    (id1, id2), _ = max(m.pair_matches.items(), key=lambda kv: kv[1].shape[0])
    m._new_point = lambda X, obs: None
    assert not m._try_initialize(id1, id2)
    assert not m.R and not m.registered and m.n_points == 0
    assert not m.registered_mask.any()
    assert (m.pid_of_g == -1).all()
    assert not m._pid_live.any() and not m.pair_set
    assert (m.per_img_cand == 0).all() and (m.nbr_assigned == 0).all()


def test_disconnected_scene_builds_multiple_models(tmp_path):
    """tests/test_mapper.py:197 on the port: two clusters with no match
    between them give two models, and the larger is selected."""
    rng = np.random.default_rng(31)
    scene_a = jax_synthetic.random_scene(rng, num_points=180, num_cameras=5, noise_px=0.3)
    scene_b = jax_synthetic.random_scene(rng, num_points=150, num_cameras=4, noise_px=0.3)
    _scene_to_db_and_model(scene_a, tmp_path, noise=0.3, seed=31, second_scene=scene_b)[0].close()
    db = colmap_db.ColmapDatabase(str(tmp_path / "db.db"))
    model, stats = mapper.reconstruct(db, verbose=False, device="cpu")
    db.close()
    assert stats["num_models"] == 2, stats
    assert sorted(stats["model_sizes"], reverse=True) == [5, 4]
    assert stats["num_reg_images"] == 5
    names = {im.name for im in model.images.values()}
    assert all(n.startswith("a_") for n in names) or all(n.startswith("b_") for n in names)


def test_incremental_ranking_matches_full_recompute(tmp_path):
    """tests/test_mapper.py:169 on the port: the incremental candidate
    counts equal their O(E) recomputation after every filtering pass."""
    rng = np.random.default_rng(21)
    scene = jax_synthetic.random_scene(rng, num_points=200, num_cameras=6, noise_px=0.4)
    _scene_to_db_and_model(scene, tmp_path, noise=0.4, outlier_frac=0.1, seed=21)[0].close()
    m = mapper.IncrementalMapper(colmap_db.ColmapDatabase(str(tmp_path / "db.db")), device="cpu")
    checks = []
    orig_filter = m._filter_points

    def checked_filter():
        r = orig_filter()
        checks.append(np.array_equal(m.per_img_cand, m._ranking_counts_full()))
        return r

    m._filter_points = checked_filter
    assert m.reconstruct(verbose=False) is not None
    assert checks and all(checks)
