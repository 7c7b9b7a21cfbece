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


#: Port bf16 against JAX bf16.  Both round each conv once; what differs is
#: summation order and the correlation (f32 on the CPU in both).  Measured
#: 9.70e-4 (forward_sym) and 5.89e-4 (flow_from_features) on these 16
#: pairs; 1.5e-3 leaves half again as much, under JAX's own bf16-vs-f32
#: figure here (2.12e-3).
BF16_ATOL = 1.5e-3


def test_bf16_matches_jax_bf16():
    """Both nets in bf16 on 16 seeded patch pairs; each conv rounds once in
    both (FoldedConv, JAX's _FoldedConv)."""
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


def _one_rounding(x, w, b, pad):
    """bf16(max(conv(x, w) + b, 0)) with the conv of the bf16 operands in
    f64 and a single rounding to bf16 (through f32, exact for these sums)."""
    y = torch.nn.functional.conv2d(x.double(), w.double(), padding=pad)
    y = (y + b.double().view(1, -1, 1, 1)).clamp_min(0)
    return y.float().to(torch.bfloat16)


#: Share of elements in which FoldedConv in bf16 may differ from the f64
#: one-rounding result: only where the f32 sum lies within its own rounding
#: error of a bf16 rounding boundary (measured on the CPU: 0 to 6.3e-4 per
#: layer, the most 2 of head conv2's 3,200 values).  The two-pass epilogue
#: (bf16 conv, then the f32 bias added in bf16) differs in 12-18%.
CONV_DIFFER_SHARE = 2e-3


@pytest.mark.parametrize("name, cin, cout, size, k, pad", panet.MAIN_PATH_CONVS,
                         ids=[c[0] for c in panet.MAIN_PATH_CONVS])
def test_folded_conv_rounds_once(name, cin, cout, size, k, pad):
    """FoldedConv in bf16 at each conv shape of the main path (batch 2) is
    the one-rounding result, as JAX's _FoldedConv; off by one bf16 step on
    at most CONV_DIFFER_SHARE of the elements."""
    rng = np.random.default_rng(12)
    x = rng.random((2, cin, size, size)).astype(np.float32) * (255.0 if cin == 3 else 1.0)
    w = rng.standard_normal((cout, cin, k, k)).astype(np.float32) / np.sqrt(cin * k * k)
    b = (rng.standard_normal(cout) * 0.5).astype(np.float32)
    conv = panet.FoldedConv(cin, cout, k, pad)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        conv.bias.copy_(torch.from_numpy(b))
        xb = torch.from_numpy(x).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        got = conv(xb)
        wb = conv.weight.to(torch.bfloat16)
        want = _one_rounding(xb, wb, conv.bias, pad)
        two_pass = torch.nn.functional.conv2d(xb, wb, padding=pad)
        two_pass = two_pass.add_(conv.bias.view(1, -1, 1, 1)).relu_()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    differ = got.float() != want.float()
    assert differ.float().mean().item() <= CONV_DIFFER_SHARE
    # One bf16 step, plus the f32 sum's own error where the sum cancels.
    step = want.float().abs() * 2.0**-7 + want.float().abs().max() * 2.0**-20
    assert ((got.float() - want.float()).abs() <= step).all()
    assert (two_pass.float() != want.float()).float().mean().item() > 10 * CONV_DIFFER_SHARE


@pytest.mark.parametrize("cin", [3, 289])
def test_pad_channels_changes_no_conv(cin):
    """The card pads conv1_1's and head conv0's input channels to a
    multiple of 8 with zeros before cuDNN's fused conv; the padded conv is
    the same conv."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, cin, 9, 9)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.standard_normal((4, cin, 3, 3)).astype(np.float32))
    xp, wp = panet.pad_channels(x), panet.pad_channels(w)
    assert xp.shape[1] % 8 == 0 and xp.shape[1] - cin < 8 and wp.shape[1] == xp.shape[1]
    assert xp.is_contiguous(memory_format=torch.channels_last)
    assert (xp[:, cin:] == 0).all() and (wp[:, cin:] == 0).all()
    assert torch.equal(xp[:, :cin], x) and torch.equal(wp[:, :cin], w)
    np.testing.assert_allclose(torch.nn.functional.conv2d(xp, wp).numpy(),
                               torch.nn.functional.conv2d(x, w).numpy(), atol=1e-4, rtol=1e-5)
