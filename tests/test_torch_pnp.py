"""The port's PnP (lfr_tpu_torch.sfm.pnp) against lfr_tpu.sfm.pnp on
tests/test_mapper.py's two PnP scenes (exact, and with a quarter of the 3-D
points displaced).

Both packages are fed JAX's own sample indices (``jax.random.choice`` under
PRNGKey(0), as ``estimate_pose`` draws them).  The DLT's null vector has an
arbitrary sign, and JAX's pose is right only when its SVD returns P with a
positive scale (det P[:, :3] > 0); the port fixes the sign first, so:

- every hypothesis whose JAX null vector has the positive sign (and whose
  sample repeats no correspondence) gets JAX's pose and JAX's score.  The
  pose bound is CONTROL_FACTOR times a control's deviation: JAX's poses on
  inputs scaled by 1 + 2e-7 N(0, 1), against JAX's own (the port's null
  vector comes from a float64 Gram matrix, JAX's from a float32 SVD);
- a hypothesis whose JAX pose has determinant -1 is right in the port;
- the final pose and inlier set lie within what JAX's own result moves
  under another key (PRNGKey(1)): the sign fix can make a hypothesis win
  that JAX threw away, so exact equality is not required.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.sfm import pnp as jax_pnp
from lfr_tpu.utils import synthetic as jax_synthetic
from lfr_tpu_torch.sfm import pnp

CONTROL_FACTOR = 4.0
POSE_FLOOR = 1e-6

_draw = jax.jit(
    lambda key, p, n: jax.random.choice(key, n, shape=(256, 6), replace=True, p=p),
    static_argnums=2,
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


def _scene(outliers):
    """(points, normalized uv, focal, true R, true t, displaced rows) of
    tests/test_mapper.py:10 (exact) or :25 (outliers)."""
    rng = np.random.default_rng(1 if outliers else 0)
    scene = jax_synthetic.random_scene(rng, num_points=120 if outliers else 100, num_cameras=2)
    vis = np.nonzero(scene.visible[1])[0]
    f = scene.K[0, 0]
    uv = (scene.observations[1][vis] - scene.K[:2, 2]) / f
    X = scene.points[vis].copy()
    bad = np.zeros(len(vis), bool)
    if outliers:
        idx = rng.choice(len(vis), len(vis) // 4, replace=False)
        X[idx] += rng.normal(0, 1.0, (len(idx), 3))
        bad[idx] = True
    return X, uv, f, scene.rotations[1], scene.translations[1], bad


def _padded(X, uv):
    n = len(X)
    b = pnp.bucket_size(n)
    Xp = np.zeros((b, 3), np.float32)
    uvp = np.zeros((b, 2), np.float32)
    valid = np.zeros(b, bool)
    Xp[:n], uvp[:n], valid[:n] = X, uv, True
    return Xp, uvp, valid


def _jax_samples(valid, seed):
    probs = jnp.asarray(valid, jnp.float32) / int(valid.sum())
    return np.array(_draw(jax.random.PRNGKey(seed), probs, len(valid)))


@jax.jit
def _jax_hypotheses(X, uv, focal, valid, idx):
    """JAX's hypothesis stage: poses, scores, and the sign of det P[:, :3]
    of its SVD null vector."""

    def one(s):
        R, t = jax_pnp._pose_from_dlt(X[s], uv[s])
        err = jax_pnp._reproj_err_sq(R, t, X, uv, focal)
        k = s.shape[0]
        Xh = jnp.concatenate([X[s], jnp.ones((k, 1))], 1)
        z = jnp.zeros_like(Xh)
        A = jnp.concatenate([jnp.concatenate([Xh, z, -uv[s][:, 0:1] * Xh], 1),
                             jnp.concatenate([z, Xh, -uv[s][:, 1:2] * Xh], 1)], 0)
        P = jnp.linalg.svd(A, full_matrices=False)[2][-1].reshape(3, 4)
        score = jnp.sum((err <= jax_pnp.MAX_ERROR_PX**2) & valid)
        return R, t, score, jnp.linalg.det(P[:, :3])

    return jax.vmap(one)(idx)


def _port_hypotheses(Xp, uvp, focal, valid, idx):
    X, uv = torch.from_numpy(Xp), torch.from_numpy(uvp)
    R, t = pnp.pose_from_dlt(X[idx], uv[idx])
    err = pnp.reproj_err_sq(R, t, X, uv, torch.full((len(Xp),), focal))
    scores = ((err <= pnp.MAX_ERROR_PX**2) & torch.from_numpy(valid)).sum(-1)
    return R.numpy(), t.numpy(), scores.numpy()


@pytest.fixture(scope="module", params=[False, True], ids=["exact", "outliers"])
def case(request):
    X, uv, f, R_true, t_true, bad = _scene(request.param)
    Xp, uvp, valid = _padded(X, uv)
    idx = _jax_samples(valid, 0)
    args = (jnp.asarray(Xp), jnp.asarray(uvp), jnp.full(len(Xp), f, jnp.float32),
            jnp.asarray(valid), jnp.asarray(idx))
    hyp = [np.asarray(a) for a in _jax_hypotheses(*args)]
    rng = np.random.default_rng(5)
    scale = lambda a: (a * (1 + 2e-7 * rng.standard_normal(a.shape))).astype(np.float32)  # noqa: E731
    pert = [np.asarray(a) for a in _jax_hypotheses(
        jnp.asarray(scale(Xp)), jnp.asarray(scale(uvp)), *args[2:])]
    return dict(X=X, uv=uv, f=f, R_true=R_true, t_true=t_true, bad=bad, Xp=Xp, uvp=uvp,
                valid=valid, idx=idx, hyp=hyp, pert=pert)


def test_positive_sign_hypotheses_equal_jax(case):
    R_j, t_j, score_j, det_p = case["hyp"]
    R_c, t_c = case["pert"][:2]
    repeats = (np.diff(np.sort(case["idx"], 1), axis=1) == 0).any(1)
    keep = (det_p > 0) & ~repeats
    assert keep.sum() > 50
    R, t, score = _port_hypotheses(case["Xp"], case["uvp"], case["f"], case["valid"],
                                   torch.from_numpy(case["idx"]))
    bound_R = CONTROL_FACTOR * np.abs(R_c - R_j)[keep].max() + POSE_FLOOR
    bound_t = CONTROL_FACTOR * np.abs(t_c - t_j)[keep].max() + POSE_FLOOR
    assert np.abs(R - R_j)[keep].max() <= bound_R
    assert np.abs(t - t_j)[keep].max() <= bound_t
    np.testing.assert_array_equal(score[keep], score_j[keep])


def test_sign_fix_recovers_hypotheses_jax_gets_wrong(case):
    """A sample whose JAX pose has determinant -1 (its SVD returned -P) gives
    the true pose in the port, on the exact inliers."""
    R_j, t_j, score_j, det_p = case["hyp"]
    idx = case["idx"]
    repeats = (np.diff(np.sort(idx, 1), axis=1) == 0).any(1)
    clean = ~case["bad"][np.minimum(idx, len(case["bad"]) - 1)].any(1) & ~repeats
    flipped = (np.linalg.det(R_j) < 0) & clean
    assert flipped.sum() > 10
    R, t, score = _port_hypotheses(case["Xp"], case["uvp"], case["f"], case["valid"],
                                   torch.from_numpy(idx))
    assert (det_p[flipped] < 0).all()
    assert np.abs(R_j[flipped] - case["R_true"]).max() > 0.5
    assert np.abs(R[flipped] - case["R_true"]).max() < 1e-4
    assert np.abs(t[flipped] - case["t_true"]).max() < 1e-3 * np.abs(case["t_true"]).max()
    assert (score[flipped] > score_j[flipped]).all()


def test_estimate_pose_within_jax_key_control(case):
    X, uv, f = case["X"], case["uv"], case["f"]
    R0, t0, inl0 = jax_pnp.estimate_pose(X, uv, f, seed=0)
    R1, t1, inl1 = jax_pnp.estimate_pose(X, uv, f, seed=1)
    R, t, inl = pnp.estimate_pose(X, uv, f, device="cpu", samples=case["idx"])
    assert np.abs(R - R0).max() <= CONTROL_FACTOR * np.abs(R1 - R0).max() + POSE_FLOOR
    assert np.abs(t - t0).max() <= CONTROL_FACTOR * np.abs(t1 - t0).max() + POSE_FLOOR
    assert (inl != inl0).sum() <= (inl1 != inl0).sum()
    assert not inl[case["bad"]].any() or inl[case["bad"]].mean() < 0.1
    # The port's own sampler reaches the same inliers and the true pose.
    R2, t2, inl2 = pnp.estimate_pose(X, uv, f, device="cpu")
    assert (inl2 != inl0).sum() <= (inl1 != inl0).sum()
    np.testing.assert_allclose(R2, case["R_true"], atol=1e-3)  # as tests/test_mapper.py


def test_too_few_correspondences():
    X, uv, f = _scene(False)[:3]
    assert pnp.estimate_pose(X[:5], uv[:5], f, device="cpu") is None
    assert pnp.estimate_pose(X, uv, f, device="cpu", min_inliers=10_000) is None
