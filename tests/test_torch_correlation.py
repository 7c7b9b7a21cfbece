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
    correlation.correlation_nonorm(fr, ft)
    correlation.correlation_matmul(fr, ft)
    assert correlation.LAUNCHES == {
        "corr_sym": 0, "corr_asym": 0, "corr_nonorm": 0, "corr_matmul": 0
    }


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
    for wrapper in (correlation.correlation_sym, correlation.correlation_asym,
                    correlation.correlation_nonorm, correlation.correlation_matmul):
        with pytest.raises(error, match=match):
            wrapper(f_ref, f_tgt)


def _script_kernels():
    """The Pallas kernel bodies of scripts/bench_corr_variants.py, taken from
    its source: importing the script would run its platform set-up."""
    import ast
    import pathlib

    import jax
    from jax.experimental import pallas as pl

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "bench_corr_variants.py"
    tree = ast.parse(path.read_text())
    wanted = ("kernel_nonorm", "kernel_matmul_only", "kernel_norm")
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert len(body) == len(wanted)
    namespace = {"jax": jax, "jnp": jnp, "C": jax_corr}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), namespace)

    def run(kernel, fr, ft):
        b, p, c = fr.shape
        spec = pl.BlockSpec((1, p, c), lambda i: (i, 0, 0))
        ospec = pl.BlockSpec((1, p, p), lambda i: (i, 0, 0))
        return pl.pallas_call(
            kernel, grid=(b,), in_specs=[spec, spec], out_specs=ospec,
            out_shape=jax.ShapeDtypeStruct((b, p, p), jnp.float32), interpret=True,
        )(fr, ft)

    return {name: (lambda fr, ft, k=namespace[name]: run(k, fr, ft)) for name in wanted}


@pytest.mark.parametrize(
    "script_kernel, plain",
    [
        ("kernel_nonorm", lambda fr, ft: correlation.correlation_nonorm(fr, ft)),
        ("kernel_matmul_only", lambda fr, ft: correlation.correlation_matmul(fr, ft)),
        ("kernel_norm", lambda fr, ft: correlation.correlation_asym(fr, ft)),
    ],
    ids=["nonorm", "matmul", "norm"],
)
def test_plain_matches_variant_script_kernels(script_kernel, plain):
    """The wrappers' CPU path (the plain versions) against the variant
    kernels of the corr microbenchmark in interpret mode, f32 out: the same
    f32 products in another summation order, so atol 1e-5 as above."""
    fr, ft = _features(6)
    want = np.asarray(_script_kernels()[script_kernel](jnp.asarray(fr), jnp.asarray(ft)))
    got = plain(torch.from_numpy(fr), torch.from_numpy(ft))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 289, 289)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if script_kernel == "kernel_matmul_only":
        assert (want < 0).any()


def test_ablation_script_patches_the_kernel_source():
    """scripts/ablate_torch_corr.py switches parts of the kernel off by
    editing a copy of its source: every edit must still find its place."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "ablate_torch_corr.py"
    spec = importlib.util.spec_from_file_location("ablate_torch_corr", path)
    ablate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablate)
    src = ablate.patched_source()
    for switch in ablate.SWITCHES:
        assert src.count(switch) >= 1
    assert src.count("if (ABLATE_PRODUCTS) wgmma_152") == 1 and src.count("if (ABLATE_STAGE)") == 2
    assert "ABLATE_STORE && c < n_chunks" in src


def test_each_cuda_source_builds_into_its_own_hash_keyed_library(tmp_path, monkeypatch):
    """ops/cuda_build.py keys each library on its own source: editing one
    source renames its library and leaves the other's name, so its build,
    as it was; the correlation library keeps the name it had."""
    import hashlib
    import os
    import shutil

    from lfr_tpu_torch.ops import cuda_build

    assert set(cuda_build.LIBRARIES) == {"correlation", "nn_dist"}
    assert cuda_build.LIBRARIES["correlation"] is cuda_build.SIGNATURES
    with open(cuda_build.SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(cuda_build.NVCC_FLAGS).encode()).hexdigest()
    assert cuda_build.library_path("correlation") == os.path.join(
        cuda_build.BUILD_DIR, f"libcorrelation-{digest[:16]}.so")
    before = {name: cuda_build.library_path(name) for name in cuda_build.LIBRARIES}
    assert len(set(before.values())) == 2
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    assert {name: cuda_build.library_path(name) for name in before} == before
    with open(csrc / "nn_dist.cu", "a") as fh:
        fh.write("\n// edited\n")
    after = {name: cuda_build.library_path(name) for name in before}
    assert after["correlation"] == before["correlation"]
    assert after["nn_dist"] != before["nn_dist"]
