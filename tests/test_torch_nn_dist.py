"""The nearest-neighbour distances of the port's evaluation
(lfr_tpu_torch.ops.nn_dist) against the JAX package's brute force
(``LFR_EVAL_BRUTE=1``: ``_all_min_impl`` and ``_count_within_impl`` on the
CPU), and the kernel against its plain version on a card.

Both forms compute each squared distance as fma(dz, dz, fma(dy, dy,
dx * dx)) in f32 (XLA's fused form on the CPU); the plain version forms the
fused multiply-adds in f64, which can differ by one rounding where the f64
sum lands on an f32 midpoint (about one sum in 2^29), and torch's CPU
square root is not correctly rounded (one value in about 160 is 1 ulp
off; the JAX package's is).  So distances must
agree within ULPS units in the last place, and the counts within a
tolerance must agree except for queries whose squared distance lies within
ULPS of tol^2.  Some queries are planted at a tolerance's distance from a
corpus point, so that the comparison with tol^2 is exercised at its edge.

The JAX package is imported inside the tests that need it: on the card,
where there is no JAX, those skip and the ``cuda`` cases run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nn_dist.py -m cuda
"""

import numpy as np
import pytest
import torch

from lfr_tpu_torch.ops import nn_dist

TOLERANCES = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5)
ULPS = 2


@pytest.fixture
def jax_eth3d(monkeypatch):
    module = pytest.importorskip("lfr_tpu.eval.eth3d")
    monkeypatch.setenv("LFR_EVAL_BRUTE", "1")
    return module


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run on the card")
    return torch.device("cuda")


def _clouds(seed, nq, nc, planted=64):
    """Corpus in a 2 x 2 x 1 box at z = 6 and queries around it; the first
    ``planted`` queries sit at a tolerance's distance from a corpus point."""
    rng = np.random.default_rng(seed)
    corpus = rng.uniform((-1, -1, 5.5), (1, 1, 6.5), (nc, 3))
    queries = rng.uniform((-1.2, -1.2, 5.3), (1.2, 1.2, 6.7), (nq, 3))
    k = min(planted, nq, nc)
    direction = rng.standard_normal((k, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    tol = np.asarray(TOLERANCES)[rng.integers(0, len(TOLERANCES), k)]
    queries[:k] = corpus[rng.integers(0, nc, k)] + direction * tol[:, None]
    return queries.astype(np.float32), corpus.astype(np.float32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.maximum(a, b))


def _counts_agree(got_counts, want_counts, d2, tolerances=TOLERANCES):
    """Counts may differ only by queries within ULPS of a tol^2."""
    tol2 = np.square(np.asarray(tolerances, np.float32))
    for g, w, t2 in zip(got_counts, want_counts, tol2):
        near = int((np.abs(d2.astype(np.float64) - t2) <= ULPS * np.spacing(t2)).sum())
        assert abs(int(g) - int(w)) <= near, (g, w, t2, near)


@pytest.mark.parametrize("nq,nc", [(1, 1), (300, 5000), (5000, 300), (2500, 9000)])
def test_plain_min_dists_match_jax_brute_force(jax_eth3d, nq, nc):
    queries, corpus = _clouds(nq + nc, nq, nc)
    want = jax_eth3d._min_dists(queries, corpus)
    got = nn_dist.min_dists(torch.from_numpy(queries), torch.from_numpy(corpus)).numpy()
    assert got.shape == (nq,) and got.dtype == np.float32
    assert _ulps(got, want).max() <= ULPS
    d2 = nn_dist.nn_min_sq(torch.from_numpy(queries), torch.from_numpy(corpus))
    np.testing.assert_array_equal(torch.sqrt(d2).numpy(), got)


@pytest.mark.parametrize("nq,nc", [(300, 5000), (5000, 300)])
def test_plain_counts_match_jax_brute_force(jax_eth3d, monkeypatch, nq, nc):
    from lfr_tpu_torch.eval import eth3d

    # The port's brute-force route on the CPU (its plain version), which its
    # rule keeps for the card.
    monkeypatch.setattr(eth3d, "_use_brute", lambda nq, nc, device: True)
    queries, corpus = _clouds(7 * nq + nc, nq, nc)
    want = jax_eth3d._fractions_within(queries, corpus, TOLERANCES)
    got = eth3d._fractions_within(queries, corpus, TOLERANCES, device="cpu")
    d2 = nn_dist.nn_min_sq(torch.from_numpy(queries), torch.from_numpy(corpus)).numpy()
    _counts_agree(np.round(np.asarray(got) * nq), np.round(np.asarray(want) * nq), d2)
    counts = nn_dist.count_within(torch.from_numpy(queries), torch.from_numpy(corpus), TOLERANCES)
    assert counts.dtype == np.int64
    np.testing.assert_array_equal(counts / nq, got)
    # The planted queries put some tolerance's count strictly inside (0, nq).
    assert any(0 < c < nq for c in counts)


def test_routes_follow_the_jax_rule(monkeypatch):
    """The KD-tree on the CPU and below 1e8 pairs, the kernel on the card
    above; the brute-force route (the plain version on the CPU, taken here
    by patching the rule) gives the same fractions (no query near a tol)."""
    from lfr_tpu_torch.eval import eth3d

    queries, corpus = _clouds(3, 400, 2000, planted=0)
    cpu = torch.device("cpu")
    assert not eth3d._use_brute(10**5, 10**4, cpu)
    assert not eth3d._use_brute(10**2, 10**2, torch.device("cuda"))
    assert eth3d._use_brute(10**5, 10**4, torch.device("cuda"))
    assert not eth3d._use_brute(10**5, 10**3 - 1, torch.device("cuda"))
    tree = eth3d._fractions_within(queries, corpus, TOLERANCES, device="cpu")
    tree_d = eth3d._min_dists(queries, corpus, device="cpu")
    monkeypatch.setattr(eth3d, "_use_brute", lambda nq, nc, device: True)
    assert eth3d._fractions_within(queries, corpus, TOLERANCES, device="cpu") == tree
    # f64 tree against f32 brute force: f32 rounding of the coordinates.
    np.testing.assert_allclose(eth3d._min_dists(queries, corpus, device="cpu"), tree_d,
                               rtol=0, atol=1e-5)


def test_empty_inputs_and_bad_arguments():
    q = torch.zeros((3, 3))
    assert torch.isinf(nn_dist.nn_min_sq(q, torch.zeros((0, 3)))).all()
    assert nn_dist.nn_min_sq(torch.zeros((0, 3)), q).shape == (0,)
    with pytest.raises(TypeError):
        nn_dist.nn_min_sq(q.double(), q)
    with pytest.raises(ValueError):
        nn_dist.nn_min_sq(torch.zeros((3, 2)), q)


@pytest.mark.parametrize("nq,nc", [(640, 27_000_000), (25_000_000, 640), (1, 1), (70_000, 10**9)])
def test_launch_plan_fills_the_card_and_covers_the_corpus(nq, nc):
    sms = 132
    qpt, chunk = nn_dist.launch_plan(nq, nc, sms)
    qblocks = -(-nq // (nn_dist.THREADS * qpt))
    splits = -(-nc // chunk)
    assert qpt in (1, 4) and chunk % nn_dist.TILE == 0
    assert splits * chunk >= nc and (splits - 1) * chunk < nc and splits <= 65535
    tiles = -(-nc // nn_dist.TILE)
    assert qblocks * splits >= min(nn_dist.BLOCKS_PER_SM * sms, qblocks * tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nc", [(1, 1), (300, 5000), (5000, 300), (700, 300_001),
                                   (140_000, 1500)])
def test_kernel_matches_plain_on_card(cuda_device, nq, nc):
    queries, corpus = _clouds(nq * 3 + nc, nq, nc)
    q = torch.from_numpy(queries).to(cuda_device)
    c = torch.from_numpy(corpus).to(cuda_device)
    nn_dist.reset_launches()
    got = nn_dist.nn_min_sq(q, c)
    torch.cuda.synchronize()
    assert nn_dist.LAUNCHES["nn_dist"] == 1
    want = nn_dist.min_sq_reference(torch.from_numpy(queries), torch.from_numpy(corpus)).numpy()
    got = got.cpu().numpy()
    assert _ulps(got, want).max() <= ULPS
    _counts_agree(nn_dist.count_within(q, c, TOLERANCES),
                  [(want <= t).sum() for t in np.square(np.asarray(TOLERANCES, np.float32))],
                  want)
    # Deterministic: the blocks' minima meet by atomicMin.
    np.testing.assert_array_equal(nn_dist.nn_min_sq(q, c).cpu().numpy(), got)
