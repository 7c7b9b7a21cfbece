"""The port's projective geometry (lfr_tpu_torch.sfm.geometry) against
lfr_tpu.sfm.geometry on the same numpy inputs, every function.

Tolerances: F and H are compared up to scale and sign at 1e-4 relative
(max |a/|a| -+ b/|b||): JAX takes the exact null vectors by a float32 SVD,
the port by float64 inverse iteration on the Gram matrix, so they differ
by JAX's float32 error (measured up to ~7e-6 on H).  Elementwise functions
in float64 agree at 1e-10 relative, in float32 at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.sfm import geometry as jax_geometry
from lfr_tpu.utils import synthetic as jax_synthetic
from lfr_tpu_torch.sfm import geometry

MODEL_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _up_to_scale(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


@pytest.fixture(scope="module")
def scene():
    return jax_synthetic.random_scene(np.random.default_rng(0), num_points=150, num_cameras=4)


@pytest.fixture(scope="module")
def correspondences(scene):
    """Noisy float32 correspondences between cameras 0 and 1, and weights."""
    rng = np.random.default_rng(1)
    vis = scene.visible[0] & scene.visible[1]
    x1 = (scene.observations[0][vis] + rng.normal(0, 0.5, (vis.sum(), 2))).astype(np.float32)
    x2 = (scene.observations[1][vis] + rng.normal(0, 0.5, (vis.sum(), 2))).astype(np.float32)
    w = (rng.random(len(x1)) > 0.3).astype(np.float32)
    return x1, x2, w


def _poses(scene, c):
    return scene.rotations[c], scene.translations[c]


def test_rotations_projection_and_depth(scene):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(geometry.qvec_to_rotmat(_t(q)).numpy(),
                               np.asarray(jax_geometry.qvec_to_rotmat(jnp.asarray(q))), rtol=1e-5,
                               atol=1e-6)
    R, t = _poses(scene, 1)
    pts = scene.points.astype(np.float32)
    K = scene.K.astype(np.float32)
    args = [a.astype(np.float32) for a in (R, t)]
    np.testing.assert_allclose(
        geometry.project(_t(pts), *map(_t, args), _t(K)).numpy(),
        np.asarray(jax_geometry.project(jnp.asarray(pts), *map(jnp.asarray, args), jnp.asarray(K))),
        rtol=1e-5)
    np.testing.assert_allclose(
        geometry.cam_depth(_t(pts), *map(_t, args)).numpy(),
        np.asarray(jax_geometry.cam_depth(jnp.asarray(pts), *map(jnp.asarray, args))), rtol=1e-5)
    np.testing.assert_allclose(
        geometry.projection_matrix(*map(_t, args), _t(K)).numpy(),
        np.asarray(jax_geometry.projection_matrix(*map(jnp.asarray, args), jnp.asarray(K))),
        rtol=1e-5)


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_triangulate_dlt_batch(scene, noise):
    rng = np.random.default_rng(3)
    P = np.stack([K @ np.concatenate([R, t[:, None]], 1) for K, R, t in
                  ((scene.K, *_poses(scene, c)) for c in range(4))])
    uv = np.stack([scene.observations[c] for c in range(4)], 1)
    uv = (uv + rng.normal(0, noise, uv.shape)).astype(np.float32)
    T = uv.shape[0]
    Pb = np.tile(P[None], (T, 1, 1, 1)).astype(np.float32)
    mask = rng.random((T, 4)) > 0.2
    mask[:, :2] = True
    want = np.asarray(jax_geometry.triangulate_dlt_batch(*map(jnp.asarray, (Pb, uv, mask))))
    got = geometry.triangulate_dlt(*map(_t, (Pb, uv, mask))).numpy()
    depth = np.linalg.norm(want - [0, 0, 0], axis=1)
    assert (np.abs(got - want).max(axis=1) <= MODEL_RTOL * depth).all()
    if noise == 0:
        np.testing.assert_allclose(got, scene.points, atol=1e-3)


@pytest.mark.parametrize("weighted", [False, True])
def test_fundamental_and_homography_exact(correspondences, weighted):
    x1, x2, w = correspondences
    wj, wt = (jnp.asarray(w), _t(w)) if weighted else (None, None)
    F_j = jax_geometry.fundamental_8point(jnp.asarray(x1), jnp.asarray(x2), wj)
    F_t = geometry.fundamental_8point(_t(x1), _t(x2), wt)
    assert _up_to_scale(F_j, F_t) <= MODEL_RTOL
    # Rank 2, and normalized by F[2, 2] as the reference is.
    assert np.linalg.svd(F_t.double().numpy(), compute_uv=False)[2] < 1e-6 * np.abs(
        F_t.numpy()).max()
    assert F_t[2, 2].item() == pytest.approx(1.0)
    H_j = jax_geometry.homography_dlt(jnp.asarray(x1), jnp.asarray(x2), w=wj)
    H_t = geometry.homography_dlt(_t(x1), _t(x2), w=wt)
    assert _up_to_scale(H_j, H_t) <= MODEL_RTOL


def test_minimal_solvers_fast_and_batched(correspondences):
    x1, x2, _ = correspondences
    rng = np.random.default_rng(4)
    idx = np.stack([rng.choice(len(x1), 8, replace=False) for _ in range(6)])
    Fs = geometry.fundamental_8point(_t(x1[idx]), _t(x2[idx]), fast=True)
    Hs = geometry.homography_dlt(_t(x1[idx[:, :4]]), _t(x2[idx[:, :4]]), fast=True)
    for k in range(6):
        F_j = jax_geometry.fundamental_8point(jnp.asarray(x1[idx[k]]), jnp.asarray(x2[idx[k]]),
                                              fast=True)
        H_j = jax_geometry.homography_dlt(jnp.asarray(x1[idx[k, :4]]), jnp.asarray(x2[idx[k, :4]]),
                                          fast=True)
        assert _up_to_scale(F_j, Fs[k]) <= MODEL_RTOL
        assert _up_to_scale(H_j, Hs[k]) <= MODEL_RTOL
    # The exact route on a minimal (wide) system fits its own sample too.
    F = geometry.fundamental_8point(_t(x1[idx[0]]), _t(x2[idx[0]]))
    H = geometry.homography_dlt(_t(x1[idx[0, :4]]), _t(x2[idx[0, :4]]))
    assert geometry.homography_error(H, _t(x1[idx[0, :4]]), _t(x2[idx[0, :4]])).max() < 1e-4
    F_j = jax_geometry.fundamental_8point(jnp.asarray(x1[idx[0]]), jnp.asarray(x2[idx[0]]))
    assert _up_to_scale(F_j, F) <= MODEL_RTOL


def test_nullvec_of_a_singular_sample_is_nan_on_both_routes(correspondences):
    """A sample that repeats a correspondence makes the 8x8 system singular:
    both packages give NaN (no raise), so the hypothesis scores 0."""
    x1, x2, _ = correspondences
    rows = [0, 0, 1, 2, 3, 4, 5, 6]
    F_j = np.asarray(jax_geometry.fundamental_8point(jnp.asarray(x1[rows]), jnp.asarray(x2[rows]),
                                                     fast=True))
    F_t = geometry.fundamental_8point(_t(x1[rows]), _t(x2[rows]), fast=True)
    assert np.isnan(F_j).all() and torch.isnan(F_t).all()
    err = geometry.sampson_error(F_t, _t(x1), _t(x2))
    assert int((err <= 16.0).sum()) == 0
    # Batched: one singular system among regular ones leaves the others finite.
    A = torch.randn(3, 8, 9, generator=torch.Generator().manual_seed(0))
    A[1, 3] = A[1, 2]
    v = geometry.nullvec_fix_last(A)
    assert torch.isnan(v[1]).all() and torch.isfinite(v[[0, 2]]).all()
    for k in (0, 2):
        want = np.asarray(jax_geometry.nullvec_fix_last(jnp.asarray(A[k].numpy())))
        np.testing.assert_allclose(v[k].numpy(), want, rtol=1e-4, atol=1e-6)


def test_scores_match(correspondences):
    x1, x2, _ = correspondences
    F = np.asarray(jax_geometry.fundamental_8point(jnp.asarray(x1), jnp.asarray(x2)))
    H = np.asarray(jax_geometry.homography_dlt(jnp.asarray(x1), jnp.asarray(x2)))
    for fn, M in (("sampson_error", F), ("homography_error", H)):
        want = np.asarray(getattr(jax_geometry, fn)(jnp.asarray(M), jnp.asarray(x1),
                                                    jnp.asarray(x2)))
        got = getattr(geometry, fn)(_t(M), _t(x1), _t(x2)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * want.max())


def test_essential_decomposition_and_angles(scene, correspondences):
    vis = scene.visible[0] & scene.visible[1]
    x1 = scene.observations[0][vis]
    x2 = scene.observations[1][vis]
    F = np.asarray(jax_geometry.fundamental_8point(jnp.asarray(x1), jnp.asarray(x2)),
                   np.float64)
    K = scene.K
    E_j = np.asarray(jax_geometry.essential_from_fundamental(*map(jnp.asarray, (F, K, K))))
    E_t = geometry.essential_from_fundamental(*map(_t, (F, K, K))).numpy()
    np.testing.assert_allclose(E_t, E_j, rtol=1e-5, atol=1e-5 * np.abs(E_j).max())
    # The four candidates, as a set (SVD signs may differ between packages).
    cands_j = [(np.asarray(R), np.asarray(t)) for R, t in
               jax_geometry.decompose_essential(jnp.asarray(E_j))]
    for R, t in geometry.decompose_essential(_t(E_j)):
        assert min(np.abs(R.numpy() - Rj).max() + np.abs(t.numpy() - tj).max()
                   for Rj, tj in cands_j) < 1e-5
        np.testing.assert_allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-6)
    c1 = -scene.rotations[0].T @ scene.translations[0]
    c2 = -scene.rotations[1].T @ scene.translations[1]
    args = [a.astype(np.float32) for a in (scene.points, c1, c2)]
    want = np.asarray(jax_geometry.triangulation_angles(*map(jnp.asarray, args)))
    got = geometry.triangulation_angles(*map(_t, args)).numpy()
    # float32 arccos near 1: 1e-6 rad is a few ulps of the cosine.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_smallest_eigenvector_against_eigh():
    """The inverse-iteration null vector equals eigh's at 1e-6, batched,
    down to a gap ratio of 0.99 between the two smallest eigenvalues (whose
    bound is 0.99**1024 = 3e-5; it reads 1.3e-7)."""
    gen = torch.Generator().manual_seed(5)
    Q, _ = torch.linalg.qr(torch.randn(4, 9, 9, generator=gen, dtype=torch.float64))
    lam = torch.logspace(2, -1, 9, dtype=torch.float64).repeat(4, 1)
    lam[1, -1] = 0.0
    lam[2, -1] = 0.99 * lam[2, -2]
    lam[3, -1] = 1e-9
    G = Q @ torch.diag_embed(lam) @ Q.transpose(1, 2)
    got = geometry.smallest_eigenvector(G)
    want = torch.linalg.eigh(G).eigenvectors[..., 0]
    for g, w in zip(got, want):
        assert _up_to_scale(g, w) < 1e-6
