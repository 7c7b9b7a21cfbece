"""MNN matchers in the port against lfr_tpu's, f32 on the CPU.

The same matches exactly, similarities within 1e-6.  A near-tie (top-2
similarity gap or ratio within 1e-5 of its decision) may flip between two
f32 summation orders; a differing match is allowed only there, and the
tests count such matches."""

import numpy as np
import pytest
import torch

from lfr_tpu.ops import matchers as jax_matchers
from lfr_tpu_torch.ops import matchers

SIM_ATOL = 1e-6
NEAR_TIE = 1e-5


def _descriptors(seed, n1, n2, noise=0.3, dim=128):
    """Two sets sharing min(n1, n2) noisy points in random order."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((max(n1, n2), dim)).astype(np.float32)
    d1 = base[:n1] + noise * rng.standard_normal((n1, dim)).astype(np.float32)
    d2 = base[rng.permutation(max(n1, n2))[:n2]] + noise * rng.standard_normal(
        (n2, dim)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return d1, d2


def _compare(d1, d2, kind, threshold):
    """Returns the number of near-tie differences; fails on any other."""
    want_m, want_s = jax_matchers.match(d1, d2, kind, threshold)
    got_m, got_s = matchers.match(d1, d2, kind, threshold, device="cpu")
    assert got_m.dtype == np.int64 and got_s.dtype == np.float32
    if np.array_equal(got_m, want_m):
        np.testing.assert_allclose(got_s, want_s, atol=SIM_ATOL, rtol=0)
        return 0
    differ = set(map(tuple, got_m)) ^ set(map(tuple, want_m))
    assert all(matchers.decision_margin(d1, d2, i, j, threshold) < NEAR_TIE
               for i, j in differ), differ
    return len(differ)


@pytest.mark.parametrize("kind, threshold", [("ratio", 0.8), ("ratio", 0.95),
                                             ("similarity", 0.8), ("similarity", 0.5)])
@pytest.mark.parametrize("n1, n2", [(64, 48), (300, 280), (1, 5), (7, 1)])
def test_matchers_match_jax(kind, threshold, n1, n2):
    near_ties = _compare(*_descriptors(n1 * 7 + n2, n1, n2), kind, threshold)
    assert near_ties == 0


def test_ties_take_the_first_index_as_jax():
    """Exact duplicates: argmax ties resolve to the first index on both sides."""
    d1, d2 = _descriptors(4, 20, 20, noise=0.0)
    d2 = np.concatenate([d2[:5], d2[:5], d2[5:]])
    for kind in ("similarity", "ratio"):
        want = jax_matchers.match(d1, d2, kind, 0.5)[0]
        got = matchers.match(d1, d2, kind, 0.5, device="cpu")[0]
        np.testing.assert_array_equal(got, want)
    assert (matchers.match(d1, d2, "similarity", 0.5, device="cpu")[0][:, 1] < 25).all()


def test_decision_margin():
    d = np.eye(4, dtype=np.float32)
    d2 = d.copy()
    d2[1] = (d[0] + d[1]) / np.sqrt(2.0)  # rows 0 and 1 of d tie on column 1
    assert matchers.decision_margin(d, d2, 0, 0, 0.8) > 0.2
    assert matchers.decision_margin(d, d2, 1, 1, 0.8) < 1e-6


def test_empty_inputs_and_unknown_matcher():
    d = _descriptors(5, 4, 4)[0]
    for a, b in ((d[:0], d), (d, d[:0])):
        m, s = matchers.match(a, b, "ratio", 0.8, device="cpu")
        assert m.shape == (0, 2) and s.shape == (0,)
    with pytest.raises(NotImplementedError):
        matchers.match(d, d, "hamming", 0.8, device="cpu")


def test_padding_matches_jax():
    for n in (1, 255, 256, 257):
        got, n_got = matchers._pad_descriptors(np.ones((n, 125), np.float32))
        want, n_want = jax_matchers._pad_descriptors(np.ones((n, 125), np.float32))
        assert n_got == n_want and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_stacked_matching_equals_per_pair():
    """The batched form over a descriptor stack (the stream's matcher) gives
    each pair what the per-pair padded matcher gives it."""
    blocks, counts = [], []
    for seed, n in enumerate((40, 90, 17)):
        d, _ = _descriptors(seed, n, n)
        padded, valid = matchers._pad_descriptors(d)
        blocks.append(padded)
        counts.append(valid)
    stack = torch.from_numpy(np.stack(blocks))
    s1 = torch.tensor([0, 1, 2, 0])
    s2 = torch.tensor([1, 2, 0, 2])
    n = torch.tensor(counts)
    thr = torch.tensor([0.8, 0.9, 0.95, 0.8])
    for kind in ("ratio", "similarity"):
        nn12, sim, keep = matchers.match_padded(stack[s1], stack[s2], n[s1], n[s2], thr, kind)
        for p in range(4):
            one = matchers.match_padded(stack[s1[p]], stack[s2[p]], int(n[s1[p]]),
                                        int(n[s2[p]]), float(thr[p]), kind)
            for got, want in zip((nn12[p], sim[p], keep[p]), one):
                assert torch.equal(got, want)


def test_strict_f32_restores_the_callers_setting():
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        with matchers.strict_f32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
        d1, d2 = _descriptors(6, 30, 30)
        assert _compare(d1, d2, "ratio", 0.8) == 0
    finally:
        torch.set_float32_matmul_precision(saved)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d1, d2 = _descriptors(7, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        matchers.match(d1, d2, "ratio", 0.8)
