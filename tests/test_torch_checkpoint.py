"""The port's weight reader and writer, the layout conversions and the
``.pth`` import against the JAX package (flax's ``to_bytes`` and
lfr_tpu.models.torch_import)."""

import pathlib

import flax.serialization
import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from lfr_tpu.models import checkpoint as jax_checkpoint
from lfr_tpu.models import torch_import as jax_torch_import
from lfr_tpu_torch.models import checkpoint, panet, torch_import, train

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
    # An unfolded tree gives the unfolded model's state dict, which the
    # folded model refuses (and the other way round).
    unfolded = panet.from_jax_variables(
        checkpoint.load_variables(str(WEIGHTS / "panet_holdout.msgpack"))
    )
    with pytest.raises(RuntimeError, match="bn0"):
        panet.PANet(torch.float32).load_state_dict(unfolded)
    with pytest.raises(RuntimeError, match="bn0"):
        panet.PANet(torch.float32, folded=False).load_state_dict(sd)


@pytest.mark.parametrize("name", ["panet_holdout", "panet_real", "panet_cpu"])
def test_writer_bytes_equal_flax(name, tmp_path):
    path = WEIGHTS / f"{name}.msgpack"
    variables = checkpoint.load_variables(str(path))
    want = flax.serialization.to_bytes(variables)
    assert want == path.read_bytes()
    assert checkpoint.dumps(variables) == want
    out = str(tmp_path / "w.msgpack")
    checkpoint.save_variables(out, variables)
    assert (tmp_path / "w.msgpack").read_bytes() == want


def test_writer_bytes_equal_flax_for_a_trained_snapshot():
    """A snapshot after one train step of the unfolded model (the key order
    of the JAX package's snapshots), and the forms msgpack shortens: empty
    and 16+ entry maps, long keys, 0-d, empty and 17-d arrays, numpy
    scalars, payloads of exactly 1, 2, 4, 8 and 16 bytes, bin16 and bin32."""
    torch.manual_seed(0)
    model = train.load_model(panet.init_variables(3), torch.float32, "cpu").train()
    optimizer, _ = train.make_optimizer(model, 1e-3)
    rng = np.random.default_rng(0)
    ref, tgt = (torch.from_numpy((rng.random((2, 33, 33, 3)) * 255).astype(np.float32))
                for _ in range(2))
    train.train_step(model, optimizer, ref, tgt, torch.zeros(2, 2))
    snapshot = panet.to_jax_variables(model)
    assert checkpoint.dumps(snapshot) == flax.serialization.to_bytes(snapshot)
    loaded = checkpoint.loads(checkpoint.dumps(snapshot))
    assert checkpoint.dumps(loaded) == checkpoint.dumps(snapshot)
    odd = {
        "empty": {}, "many": {f"k{i:02d}": np.full(i, i, np.uint8) for i in range(18)},
        "x" * 40: np.zeros((), np.float64), "none": np.zeros((0, 3), np.float32),
        "deep": np.arange(3, dtype=np.int64).reshape((3,) + (1,) * 16),
        "scalar": np.float32(2.5), "neg": np.array([-1, -40, -200], np.int16),
        "big": np.ones((300, 250), np.uint8), "huge": np.ones(70_000, np.uint8),
    }
    assert checkpoint.dumps(odd) == flax.serialization.to_bytes(odd)
    back = checkpoint.loads(checkpoint.dumps(odd))
    assert back["scalar"] == np.float32(2.5) and isinstance(back["scalar"], np.float32)


def _reference_state_dict(seed=0):
    """A state dict in the reference's layout (reference: model.py:12-41),
    as tests/test_panet.py's oracle builds it, with randomised statistics."""
    torch.manual_seed(seed)
    backbone = tnn.Sequential(
        tnn.Conv2d(3, 64, 3, padding=1), tnn.ReLU(), tnn.Conv2d(64, 64, 3, padding=1), tnn.ReLU(),
        tnn.MaxPool2d(3, 2, 1), tnn.Conv2d(64, 128, 3, padding=1), tnn.ReLU(),
        tnn.Conv2d(128, 128, 3, padding=1), tnn.ReLU())
    layers = []
    for cin, cout in ((289, 128), (128, 128), (128, 64), (64, 64)):
        layers += [tnn.Conv2d(cin, cout, 5), tnn.BatchNorm2d(cout), tnn.ReLU()]
    net = tnn.Module()
    net.backbone, net.refine_net = backbone, tnn.Sequential(*layers)
    net.predict_net = tnn.Sequential(tnn.Linear(64, 2))
    for m in net.modules():
        if isinstance(m, tnn.BatchNorm2d):
            m.running_mean.normal_(0, 0.05)
            m.running_var.uniform_(0.5, 1.5)
            m.weight.data.uniform_(0.5, 1.5)
    return net.state_dict()


def test_pth_import_and_load_any_equal_jax(tmp_path):
    sd = _reference_state_dict()
    want = _leaves(jax_torch_import.variables_from_torch_state_dict(sd))
    got = _leaves(torch_import.variables_from_torch_state_dict(sd))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    path = str(tmp_path / "checkpoint.pth")
    torch.save({"model": sd}, path)
    for loaded in (torch_import.load_checkpoint(path), checkpoint.load_any(path)):
        ours = _leaves(loaded)
        theirs = _leaves(jax_checkpoint.load_any(path))
        assert ours.keys() == theirs.keys()
        for key in theirs:
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    msgpack_path = str(WEIGHTS / "panet_holdout.msgpack")
    assert checkpoint.dumps(checkpoint.load_any(msgpack_path)) == open(msgpack_path, "rb").read()
    # An imported tree serves the unfolded model and the folding as a
    # framework checkpoint does.
    model = train.load_model(torch_import.load_checkpoint(path), torch.float32, "cpu")
    ours = _leaves(panet.to_jax_variables(model))
    assert ours.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(ours[key], want[key], err_msg=key)
    panet.PANet(torch.float32).load_state_dict(
        panet.from_jax_variables(panet.fold_bn_variables(torch_import.load_checkpoint(path))))
