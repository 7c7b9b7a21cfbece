"""Correlation: the port's plain version against the Pallas kernels (interpret
mode) and the kernel wrappers' input checks.  The CUDA kernels themselves are
tested on the card by tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.ops import correlation as jax_corr
from lfr_tpu_torch.ops import correlation


def _features(seed, b=2):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((2, b, 289, 128)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("sym", [True, False])
def test_plain_matches_pallas_interpret(sym):
    fr, ft = _features(0)
    want = jax_corr.correlation_pallas(
        jnp.asarray(fr), jnp.asarray(ft), sym=sym, interpret=True, out_dtype=jnp.float32
    )
    got = correlation.corr_views(torch.from_numpy(fr), torch.from_numpy(ft), sym=sym)
    want = want if sym else (want,)
    got = got if sym else (got,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 289, 289)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_bf16_output_path_within_quantization():
    """The kernels write bf16 like the Pallas kernels do; both stay within
    bf16 quantisation of the f32 plain version (tests/test_ops.py)."""
    fr, ft = _features(1)
    c12_b, c21_b = jax_corr.correlation_pallas(jnp.asarray(fr), jnp.asarray(ft), interpret=True)
    c12, c21 = correlation.correlation_reference(torch.from_numpy(fr), torch.from_numpy(ft))
    for bf16, f32 in ((c12_b, c12), (c21_b, c21)):
        np.testing.assert_allclose(np.asarray(bf16, np.float32), f32.numpy(), atol=4e-3)
        np.testing.assert_allclose(
            f32.to(torch.bfloat16).float().numpy(), np.asarray(bf16, np.float32), atol=4e-3
        )


def test_cpu_path_counts_no_launch():
    correlation.reset_launches()
    fr, ft = (torch.from_numpy(x) for x in _features(2, b=1))
    correlation.correlation_sym(fr, ft)
    correlation.correlation_asym(fr, ft)
    assert correlation.LAUNCHES == {"corr_sym": 0, "corr_asym": 0}


def _meta(shape=(3, 289, 128), dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "f_ref, f_tgt, error, match",
    [
        (_meta(dtype=torch.float32), _meta(), TypeError, "bfloat16"),
        (_meta((3, 384, 128)), _meta(), ValueError, "shape"),
        (_meta((3, 128, 289)).transpose(1, 2), _meta(), ValueError, "contiguous"),
        (_meta((3, 289, 128)), _meta((2, 289, 128)), ValueError, "must match"),
        (_meta(), _meta(), ValueError, "CUDA"),
    ],
    ids=["dtype", "shape", "contiguity", "mismatch", "device"],
)
def test_kernel_wrappers_reject_bad_inputs(f_ref, f_tgt, error, match):
    for wrapper in (correlation.correlation_sym, correlation.correlation_asym):
        with pytest.raises(error, match=match):
            wrapper(f_ref, f_tgt)
