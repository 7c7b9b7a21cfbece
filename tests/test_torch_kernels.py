"""The CUDA correlation kernels against their plain version, on the card.

This file imports neither jax nor lfr_tpu, so it also runs where they are
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from lfr_tpu_torch.ops import correlation

#: bf16 output: values <= 1 round by at most 2^-9; the rest is f32 order.
ATOL = 8e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run on the card")
    return torch.device("cuda")


def _features(seed, b, device):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((2, b, 289, 128)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return (torch.from_numpy(x).to(device, torch.bfloat16) for x in f)


#: Every residue of a pair's output offset mod 16 (167,042 p bytes, so 2p mod
#: 16: B = 1..9 covers p = 0..8), an odd batch below the SM count, and one
#: above it, so that each persistent block walks several pairs.
BATCHES = [1, 2, 3, 4, 5, 6, 7, 8, 9, 37, 300]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("sym", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, sym, batch):
    fr, ft = _features(3, batch, cuda_device)
    correlation.reset_launches()
    got = correlation.corr_views(fr, ft, sym=sym)
    torch.cuda.synchronize()
    want = correlation.correlation_reference(fr, ft)
    got = got if sym else (got,)
    want = want if sym else want[:1]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == (batch, 289, 289)
        assert (g.float() - w).abs().max().item() <= ATOL
    assert correlation.LAUNCHES == {
        "corr_sym": int(sym), "corr_asym": int(not sym), "corr_nonorm": 0, "corr_matmul": 0
    }


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [3, 300])
def test_sym_views_on_card(cuda_device, batch):
    """Both views of one launch: c21 is the other view's volume (rows are
    target positions), not c12 transposed and renormalised by chance, and
    each equals the asym kernel run with the roles swapped."""
    fr, ft = _features(6, batch, cuda_device)
    c12, c21 = correlation.correlation_sym(fr, ft)
    a12 = correlation.correlation_asym(fr, ft)
    a21 = correlation.correlation_asym(ft, fr)
    torch.cuda.synchronize()
    assert torch.equal(c12, a12) and torch.equal(c21, a21)
    assert (c12.float() - c21.float()).abs().max().item() > 10 * ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize(
    "wrapper, plain, key",
    [
        (correlation.correlation_nonorm, correlation._relu_corr, "corr_nonorm"),
        (correlation.correlation_matmul, correlation._corr, "corr_matmul"),
    ],
    ids=["nonorm", "matmul"],
)
def test_variant_kernel_matches_plain_on_card(cuda_device, wrapper, plain, key, batch):
    """The unnormalised variants write values up to |c| <= 1 (unit rows), so
    the same bf16 bound holds."""
    fr, ft = _features(5, batch, cuda_device)
    correlation.reset_launches()
    got = wrapper(fr, ft)
    torch.cuda.synchronize()
    want = plain(fr, ft)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (batch, 289, 289)
    assert (got.float() - want).abs().max().item() <= ATOL
    assert correlation.LAUNCHES[key] == 1 and sum(correlation.LAUNCHES.values()) == 1
    if key == "corr_matmul":
        assert (got < 0).any()
    else:
        assert (got >= 0).all()


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_card(cuda_device):
    fr, ft = _features(4, 2, cuda_device)
    flat = torch.empty(2 * 289 * 128 + 1, dtype=torch.bfloat16, device=cuda_device)
    misaligned = flat[1:].view(2, 289, 128)
    with pytest.raises(ValueError, match="aligned"):
        correlation.correlation_asym(misaligned, ft)
    with pytest.raises(TypeError, match="bfloat16"):
        correlation.correlation_sym(fr.float(), ft.float())
    with pytest.raises(ValueError, match="must match"):
        correlation.correlation_asym(fr.cpu(), ft)
    for wrapper in (correlation.correlation_nonorm, correlation.correlation_matmul):
        with pytest.raises(ValueError, match="aligned"):
            wrapper(misaligned, ft)
        with pytest.raises(TypeError, match="bfloat16"):
            wrapper(fr.float(), ft.float())
