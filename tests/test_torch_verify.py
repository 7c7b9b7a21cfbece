"""The port's RANSAC verification (lfr_tpu_torch.sfm.verify) against
lfr_tpu.sfm.verify.

With the JAX package's own sample indices (reproduced from the same key
path: fold_in(PRNGKey(seed), i), split into the F and H keys, then
``jax.random.choice`` as ``_ransac_fundamental`` draws them), the inlier
masks must be equal except matches whose Sampson / transfer error lies
within NEAR_THRESHOLD (relative) of the 4 px threshold under either
package's model; they are counted, and none is expected.  With the port's
own sampler (BatchedVerifier), a pair's configuration must equal JAX's and
the inlier sets may differ in at most SAMPLER_DIFFER_SHARE of the matches,
and by no more than 1.25 times what JAX's own verifier differs from itself
under another seed: on the six-camera scene with 30% outliers JAX's seeds 0,
1 and 2 differ pairwise in 112-134 of 7,550 matches (1.5-1.8%), the port
(seed 0) from JAX (seed 0) in 131.  Matches whose error lies near the 4 px
threshold flip with the sample set, whichever package draws it.

One difference is by design: a sample that repeats a correspondence
(sampling is with replacement) gives a singular minimal system.  JAX's LU
turns some such samples into NaN and others, by its rounding, into an
arbitrary model of the sample's family that can score; the port scores
every such hypothesis 0.  Where JAX's winning hypothesis comes from such a
sample the two results differ; the parity test finds those cases with
JAX's own hypothesis stage and leaves them out (one of the eight here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.sfm import verify as jax_verify
from lfr_tpu.utils import synthetic as jax_synthetic
from lfr_tpu_torch.sfm import geometry, verify

NEAR_THRESHOLD = 1e-3
SAMPLER_DIFFER_SHARE = 0.02


def _pair_data(scene, a, b, rng, outlier_share, noise=0.5, limit=None):
    """Keypoints of cameras a, b (noisy) and their putative matches: the
    first ``limit`` shared points, with ``outlier_share`` of them rewired at
    random."""
    vis = np.nonzero(scene.visible[a] & scene.visible[b])[0][:limit]
    kps1 = scene.observations[a] + rng.normal(0, noise, scene.observations[a].shape)
    kps2 = scene.observations[b] + rng.normal(0, noise, scene.observations[b].shape)
    m = np.stack([vis, vis], 1)
    bad = rng.choice(len(m), int(outlier_share * len(m)), replace=False)
    m[bad, 1] = rng.integers(0, len(kps2), len(bad))
    return kps1, kps2, m


@pytest.fixture(scope="module")
def scene():
    return jax_synthetic.random_scene(np.random.default_rng(0), num_points=700, num_cameras=6)


def _jax_samples(x1p, valid, seed, index):
    """The F and H sample indices of JAX's batched verifier for pair
    ``index`` under ``seed``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), index)
    k_f, k_h = jax.random.split(key)
    n = x1p.shape[0]
    probs = jnp.asarray(valid, jnp.float32) / max(int(valid.sum()), 1)
    draw = jax.jit(lambda k, p, s: jax.random.choice(k, n, shape=(256, s), replace=True, p=p),
                   static_argnums=2)
    return np.asarray(draw(k_f, probs, 8)), np.asarray(draw(k_h, probs, 4)), k_f, k_h


def _near_threshold(models, x1, x2, error):
    """Per match: does its error lie within NEAR_THRESHOLD of the threshold
    under any of ``models``?"""
    thr = verify.MAX_ERROR_PX**2
    near = np.zeros(len(x1), bool)
    for M in models:
        e = error(torch.from_numpy(np.asarray(M, np.float64)), torch.from_numpy(x1).double(),
                  torch.from_numpy(x2).double()).numpy()
        near |= np.abs(e / thr - 1.0) <= NEAR_THRESHOLD
    return near


#: (camera a, camera b, outlier share, seed, pair index, matches); the last
#: pair has more than MATCH_BUCKET matches, so it pads to 1024 rows.
CASES = [(0, 1, 0.3, 0, 0, 60), (0, 3, 0.3, 1, 5, 200), (2, 4, 0.1, 2, 9, 400),
         (1, 2, 0.5, 3, 2, None)]


def _jax_winner_repeats(x1p, x2p, valid, idx, kind):
    """Does the winning hypothesis of JAX's RANSAC (its hypothesis stage,
    ``one_hypothesis`` of ``_ransac_fundamental`` / ``_ransac_homography``,
    run on the same samples) come from a sample that repeats a
    correspondence?"""
    from lfr_tpu.sfm import geometry as jax_geometry

    if kind == "F":
        est, err = (lambda a, b: jax_geometry.fundamental_8point(a, b, fast=True),
                    jax_geometry.sampson_error)
    else:
        est, err = (lambda a, b: jax_geometry.homography_dlt(a, b, fast=True),
                    jax_geometry.homography_error)
    X1, X2, V = (jnp.asarray(a) for a in (x1p, x2p, valid))
    thr = verify.MAX_ERROR_PX**2
    scores = np.asarray(jax.vmap(
        lambda si: jnp.sum((err(est(X1[si], X2[si]), X1, X2) <= thr) & V))(jnp.asarray(idx)))
    best = int(scores.argmax())
    return len(set(idx[best].tolist())) < idx.shape[1]


def test_ransac_with_jax_samples_gives_jax_inliers(scene):
    rng = np.random.default_rng(1)
    data = []
    for a, b, share, seed, index, limit in CASES:
        kps1, kps2, m = _pair_data(scene, a, b, rng, share, limit=limit)
        x1 = kps1[m[:, 0]].astype(np.float32)
        x2 = kps2[m[:, 1]].astype(np.float32)
        x1p, valid = jax_verify._pad_points(x1, jax_verify.MATCH_BUCKET)
        x2p, _ = jax_verify._pad_points(x2, jax_verify.MATCH_BUCKET)
        data.append((limit, x1p, x2p, valid) + _jax_samples(x1p, valid, seed, index))
    assert {d[1].shape[0] for d in data} == {512, 1024}
    counted = {"F": 0, "H": 0}
    repeated_winners = []
    for limit, x1p, x2p, valid, idx_f, idx_h, k_f, k_h in data:
        args = [jnp.asarray(a) for a in (x1p, x2p, valid)]
        want = {"F": jax_verify._ransac_fundamental(*args, k_f),
                "H": jax_verify._ransac_homography(*args, k_h)}
        t = [torch.from_numpy(a) for a in (x1p, x2p, valid)]
        got = {"F": verify.ransac_fundamental(*t, torch.from_numpy(idx_f.copy())),
               "H": verify.ransac_homography(*t, torch.from_numpy(idx_h.copy()))}
        for kind, error, idx in (("F", geometry.sampson_error, idx_f),
                                 ("H", geometry.homography_error, idx_h)):
            if _jax_winner_repeats(x1p, x2p, valid, idx, kind):
                repeated_winners.append((kind, limit))
                continue
            (M_j, inl_j, n_j), (M_t, inl_t, n_t) = want[kind], got[kind]
            differ = np.asarray(inl_j) != inl_t.numpy()
            near = _near_threshold([M_j, M_t.numpy()], x1p, x2p, error)
            assert not (differ & ~near).any(), (kind, limit, int(differ.sum()))
            counted[kind] += int(differ.sum())
            assert int(n_j) - int(n_t) == int(np.asarray(inl_j).sum()) - int(inl_t.sum())
    assert counted == {"F": 0, "H": 0}
    # On this data, one: the H RANSAC of the 60-match pair, whose JAX winner
    # scores 22 against 19 for the best sample of 4 distinct matches.  Which
    # repeated samples JAX's LU turns into NaN depends on its rounding, so
    # the count is bounded, not pinned.
    assert len(repeated_winners) <= 2, repeated_winners


def test_ransac_batched_equals_one_pair_at_a_time(scene):
    """Pairs of one padded size batched together give what each gives alone,
    and a hypothesis whose sample repeats a correspondence scores 0 without
    raising."""
    rng = np.random.default_rng(2)
    xs, ids = [], []
    for a, b in ((0, 1), (1, 2), (3, 4)):
        kps1, kps2, m = _pair_data(scene, a, b, rng, 0.3, limit=300)
        x1p, valid = verify._pad_points(kps1[m[:, 0]].astype(np.float32), 512)
        x2p, _ = verify._pad_points(kps2[m[:, 1]].astype(np.float32), 512)
        xs.append((x1p, x2p, valid))
        ids.append(verify.sample_indices(7, len(ids), int(valid.sum()), 512))
    # Pair 0: every F sample but the 6th repeats its first correspondence.
    idx_f0 = ids[0][0].clone()
    idx_f0[:, 1] = idx_f0[:, 0]
    idx_f0[5] = ids[0][0][5]
    ids[0] = (idx_f0, ids[0][1])
    stack = [torch.from_numpy(np.stack([x[k] for x in xs])) for k in range(3)]
    packed = verify.verify_batch(*stack, torch.stack([i[0] for i in ids]),
                                 torch.stack([i[1] for i in ids]))
    for k, (x, (idx_f, idx_h)) in enumerate(zip(xs, ids)):
        alone = verify.verify_batch(*[torch.from_numpy(a)[None] for a in x], idx_f[None],
                                    idx_h[None])
        torch.testing.assert_close(packed[k], alone[0], rtol=0, atol=0)
    only_sixth = verify.ransac_fundamental(*[torch.from_numpy(a) for a in xs[0]],
                                           idx_f0[5:6])
    assert int(only_sixth[2]) == int(packed[0, 0])


def _inlier_sets(results):
    return {token: (tvg.config, {tuple(r) for r in tvg.inlier_matches.tolist()})
            for token, tvg in results}


def _run(verifier, pairs):
    out = []
    for token, (kps1, kps2, m) in pairs.items():
        verifier.add(token, kps1, kps2, m)
        out.extend(verifier.ready())
    out.extend(verifier.flush())
    return _inlier_sets(out)


def _differ(a, b):
    return sum(len(a[k][1] ^ b[k][1]) for k in a)


def test_batched_verifier_with_its_own_sampler(scene, monkeypatch):
    """Six cameras, 30% of each pair's matches rewired: the port's
    BatchedVerifier (its own samples) against JAX's, pair by pair.  Batches
    of 8 pairs at 512 rows (BATCH_MATCHES cut) put batches in flight while
    pairs are added."""
    monkeypatch.setattr(verify, "BATCH_MATCHES", 2048)
    rng = np.random.default_rng(3)
    pairs = {(a, b): _pair_data(scene, a, b, rng, 0.3, limit=100 + 110 * b)
             for a in range(6) for b in range(a + 1, 6)}
    n_matches = sum(len(m) for _, _, m in pairs.values())
    port_v = verify.BatchedVerifier(seed=0, device="cpu")
    got = _run(port_v, pairs)
    want = _run(jax_verify.BatchedVerifier(seed=0), pairs)
    jax_other_seed = _run(jax_verify.BatchedVerifier(seed=1), pairs)
    assert want.keys() == got.keys() and len(got) == 15
    assert port_v.counters["pairs"] == 15 and port_v.counters["batches"] >= 3
    for token in want:
        assert got[token][0] == want[token][0], token
    differ = _differ(got, want)
    assert differ <= SAMPLER_DIFFER_SHARE * n_matches
    assert differ <= 1.25 * _differ(jax_other_seed, want)
    assert {c for c, _ in got.values()} == {verify.CONFIG_UNCALIBRATED}


def test_samples_depend_on_seed_and_index_only():
    a = verify.sample_indices(3, 11, 40, 512)
    b = verify.sample_indices(3, 11, 40, 512)
    c = verify.sample_indices(3, 12, 40, 512)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (256, 8) and a[1].shape == (256, 4)
    assert int(a[0].max()) < 40 and int(a[1].max()) < 40


def test_verify_pair_and_degenerate_pairs(scene):
    rng = np.random.default_rng(4)
    kps1, kps2, m = _pair_data(scene, 0, 1, rng, 0.3)
    r = verify.verify_pair(kps1, kps2, m, device="cpu")
    assert r.config == verify.CONFIG_UNCALIBRATED and len(r.inlier_matches) > 0.6 * len(m)
    few = verify.verify_pair(np.zeros((5, 2)), np.zeros((5, 2)), np.zeros((5, 2), int),
                             device="cpu")
    assert few.config == verify.CONFIG_DEGENERATE and few.inlier_matches.shape == (0, 2)
    # Planar pair: every correspondence on one homography.
    x1 = rng.uniform(0, 600, (60, 2))
    H = np.array([[1.1, 0.05, 7.0], [-0.03, 0.95, -4.0], [1e-4, 2e-5, 1.0]])
    p = np.c_[x1, np.ones(60)] @ H.T
    planar = verify.verify_pair(x1, p[:, :2] / p[:, 2:], np.stack([np.arange(60)] * 2, 1),
                                device="cpu")
    assert planar.config == verify.CONFIG_PLANAR_OR_PANORAMIC


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify.BatchedVerifier()
