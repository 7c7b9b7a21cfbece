"""Folded PANet in the port against lfr_tpu's PANet(folded=True), f32."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.models import checkpoint as jax_checkpoint
from lfr_tpu.models import panet as jax_panet
from lfr_tpu_torch.models import checkpoint, panet

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "weights" / "panet_holdout.msgpack"

#: f32 bound of tests/test_panet.py (JAX vs a torch oracle).
ATOL = 5e-4


@pytest.fixture(scope="module")
def models():
    folded = jax_panet.fold_bn_variables(jax_checkpoint.load_variables(str(WEIGHTS)))
    ours = panet.PANet(torch.float32)
    ours.load_state_dict(
        panet.from_jax_variables(panet.fold_bn_variables(checkpoint.load_variables(str(WEIGHTS))))
    )
    return jax_panet.PANet(jnp.float32, folded=True), folded, ours.eval()


def _patches(seed, b=4, size=33):
    rng = np.random.default_rng(seed)
    raw = (rng.random((b, size, size, 3)) * 255).astype(np.float32)
    return np.array(jax_panet.normalize_patches(jnp.asarray(raw)))


def _features(jax_model, variables, patches):
    return np.array(
        jax_model.apply(variables, jnp.asarray(patches), method=lambda m, x: m.features(x))
    )


def test_features(models):
    jm, jv, ours = models
    x = _patches(0)
    with torch.no_grad():
        got = ours.features(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 17, 17, 128)
    np.testing.assert_allclose(got, _features(jm, jv, x), atol=ATOL)


def test_forward(models):
    jm, jv, ours = models
    ref, tgt = _patches(1), _patches(2)
    want = np.asarray(jm.apply(jv, jnp.asarray(ref), jnp.asarray(tgt)))
    with torch.no_grad():
        got = ours(torch.from_numpy(ref), torch.from_numpy(tgt)).numpy()
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_forward_sym(models):
    jm, jv, ours = models
    ref, tgt = _patches(3), _patches(4)
    w12, w21 = jm.apply(jv, jnp.asarray(ref), jnp.asarray(tgt), method=jax_panet.PANet.forward_sym)
    with torch.no_grad():
        g12, g21 = ours.forward_sym(torch.from_numpy(ref), torch.from_numpy(tgt))
    np.testing.assert_allclose(g12.numpy(), np.asarray(w12), atol=ATOL)
    np.testing.assert_allclose(g21.numpy(), np.asarray(w21), atol=ATOL)


def test_flow_from_features(models):
    """Head input layout: rows of the volume are the head's source grid,
    its columns the head's 289 channels (target positions)."""
    jm, jv, ours = models
    fr = _features(jm, jv, _patches(5))
    ft = _features(jm, jv, _patches(6))
    want = np.asarray(
        jm.apply(jv, jnp.asarray(fr), jnp.asarray(ft), method=jax_panet.PANet.flow_from_features)
    )
    with torch.no_grad():
        got = ours.flow_from_features(torch.from_numpy(fr), torch.from_numpy(ft)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    with torch.no_grad():
        swapped = ours.flow_from_features(torch.from_numpy(ft), torch.from_numpy(fr)).numpy()
    assert np.abs(swapped - want).max() > 10 * ATOL


def test_fully_folded_raw_patches(models):
    """With the ImageNet normalisation folded into conv1_1 as well (the
    refiner's weights), both nets take raw [0, 255] patches."""
    jm, _, _ = models
    variables = checkpoint.load_variables(str(WEIGHTS))
    jv = jax_panet.fold_normalize_variables(jax_panet.fold_bn_variables(variables))
    ours = panet.PANet(torch.float32)
    ours.load_state_dict(
        panet.from_jax_variables(panet.fold_normalize_variables(panet.fold_bn_variables(variables)))
    )
    rng = np.random.default_rng(7)
    raw = (rng.random((2, 4, 33, 33, 3)) * 255).astype(np.float32)
    w12, w21 = jm.apply(jv, jnp.asarray(raw[0]), jnp.asarray(raw[1]),
                        method=jax_panet.PANet.forward_sym)
    with torch.no_grad():
        g12, g21 = ours.eval().forward_sym(torch.from_numpy(raw[0]), torch.from_numpy(raw[1]))
    np.testing.assert_allclose(g12.numpy(), np.asarray(w12), atol=ATOL)
    np.testing.assert_allclose(g21.numpy(), np.asarray(w21), atol=ATOL)


def test_fold_functions_match_jax():
    variables = checkpoint.load_variables(str(WEIGHTS))
    ours = panet.fold_normalize_variables(panet.fold_bn_variables(variables))
    theirs = jax_panet.fold_normalize_variables(jax_panet.fold_bn_variables(variables))
    for group, name in [("backbone", "conv1_1"), ("refine", "conv0"), ("refine", "conv3")]:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(
                ours["params"][group][name][leaf],
                np.asarray(theirs["params"][group][name][leaf]),
                rtol=1e-6, atol=1e-6,
            )
    assert "batch_stats" not in ours


#: bf16 bound of tests/test_panet.py.
BF16_ATOL = 5e-3


def test_bf16_matches_jax_bf16():
    """Both nets in bf16 on 16 seeded patch pairs.  The port rounds each
    conv twice where JAX's _FoldedConv rounds once (FoldedConv's
    docstring); the difference stays inside the bf16 bound."""
    folded = jax_panet.fold_bn_variables(jax_checkpoint.load_variables(str(WEIGHTS)))
    jm = jax_panet.PANet(jnp.bfloat16, folded=True)
    ours = panet.PANet(torch.bfloat16)
    ours.load_state_dict(
        panet.from_jax_variables(panet.fold_bn_variables(checkpoint.load_variables(str(WEIGHTS))))
    )
    ours.eval()
    ref, tgt = _patches(8, b=16), _patches(9, b=16)
    w12, w21 = jm.apply(folded, jnp.asarray(ref), jnp.asarray(tgt),
                        method=jax_panet.PANet.forward_sym)
    with torch.no_grad():
        g12, g21 = ours.forward_sym(torch.from_numpy(ref), torch.from_numpy(tgt))
    np.testing.assert_allclose(g12.float().numpy(), np.asarray(w12, np.float32), atol=BF16_ATOL)
    np.testing.assert_allclose(g21.float().numpy(), np.asarray(w21, np.float32), atol=BF16_ATOL)

    fr = _features(jm, folded, ref).astype(np.float32)
    ft = _features(jm, folded, tgt).astype(np.float32)
    want = jm.apply(folded, jnp.asarray(fr), jnp.asarray(ft),
                    method=jax_panet.PANet.flow_from_features)
    with torch.no_grad():
        got = ours.flow_from_features(torch.from_numpy(fr), torch.from_numpy(ft))
    assert got.shape == (16, 2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL)
