"""The port's weight reader and layout conversion against the JAX package."""

import pathlib

import jax
import numpy as np
import pytest
import torch

from lfr_tpu.models import checkpoint as jax_checkpoint
from lfr_tpu_torch.models import checkpoint, panet

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "weights"


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in flat}


@pytest.mark.parametrize("name", ["panet_holdout", "panet_real", "panet_cpu"])
def test_reader_matches_flax_bit_exact(name):
    path = str(WEIGHTS / f"{name}.msgpack")
    ours = _leaves(checkpoint.load_variables(path))
    theirs = _leaves(jax_checkpoint.load_variables(path))
    assert ours.keys() == theirs.keys()
    for key, want in theirs.items():
        got = ours[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key


def test_reader_rejects_truncated_and_foreign_data():
    data = (WEIGHTS / "panet_cpu.msgpack").read_bytes()
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.loads(data[: len(data) // 2])
    with pytest.raises(ValueError, match="trailing"):
        checkpoint.loads(data + b"\x00")
    with pytest.raises(ValueError, match="extension type 5"):
        checkpoint.loads(b"\x81\xa1a\xd4\x05\x00")  # {"a": fixext1 of type 5}


def test_from_jax_variables_layouts_round_trip():
    variables = panet.fold_bn_variables(
        checkpoint.load_variables(str(WEIGHTS / "panet_holdout.msgpack"))
    )
    sd = panet.from_jax_variables(variables)
    model = panet.PANet(torch.float32)
    model.load_state_dict(sd)  # strict: every key and shape matches
    params = variables["params"]
    w = sd["refine.conv0.weight"]
    assert tuple(w.shape) == (128, 289, 5, 5)
    np.testing.assert_array_equal(
        w.numpy().transpose(2, 3, 1, 0), params["refine"]["conv0"]["kernel"]
    )
    assert tuple(sd["backbone.conv1_1.weight"].shape) == (64, 3, 3, 3)
    np.testing.assert_array_equal(sd["predict.weight"].numpy().T, params["predict"]["kernel"])
    with pytest.raises(ValueError, match="fold"):
        panet.from_jax_variables(
            checkpoint.load_variables(str(WEIGHTS / "panet_holdout.msgpack"))
        )
