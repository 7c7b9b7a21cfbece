"""The port's training path (unfolded PANet, Adam under optax's schedule,
the samplers, the corpus, ``train``) against lfr_tpu.models.train.

Tolerances, and why:

- Forward passes at f32: eval mode within ``EVAL_ATOL`` units (reads about
  3e-7); train mode within ``TRAIN_ATOL`` and batch statistics within
  ``STATS_RTOL`` of each leaf's largest value.  Train mode is looser because
  flax's fast variance E[x^2] - E[x]^2 cancels: bn0's variance is about 0.02
  against a squared mean near 2, so the reductions' order (XLA's against
  torch's) shows at 100 times f32 rounding (reads about 2e-5).
- bf16: the port's bf16 forward (displacements and loss) must lie within
  ``BF16_FACTOR`` = 2 times the distance between JAX's bf16 and JAX's f32
  forward from JAX's bf16: two bf16 roundings of one f32 computation, each
  about that far from it, differ by up to twice that.  The batch statistics
  are not compared at bf16: XLA's CPU compiler keeps excess precision and
  does not round the head's conv outputs to bf16 before the f32 BatchNorm,
  where flax's code (and the port, and cuDNN on the card) does; bn0's mean
  then differs by 2.8e-4 against 4e-5 with the rounding left out in the
  port too.
- Adam steps: Adam's first step moves each parameter by about lr times the
  sign of its gradient, so an entry whose gradient is at rounding level can
  flip, in any two f32 implementations.  Each comparison (loss per step;
  the parameters as one relative norm of the difference over the update;
  the batch statistics likewise) is held within ``CONTROL_FACTOR`` times
  the larger of two controls of the same nature: JAX against JAX on inputs
  scaled by 1 + 2e-7 N(0, 1), and the port against itself with oneDNN off
  (PyTorch's other CPU convolution, another summation order).  The conv
  biases of the head have no gradient at all (the BatchNorm that follows
  removes any per-channel constant), so every implementation moves them by
  rounding noise; they form their own group under the same rule.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lfr_tpu.models import panet as jax_panet
from lfr_tpu.models import train as jax_train
from lfr_tpu.utils import corpus as jax_corpus
from lfr_tpu_torch.models import checkpoint, panet, train
from lfr_tpu_torch.utils import corpus

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "weights"

EVAL_ATOL = 1e-5
TRAIN_ATOL = 1e-4
STATS_RTOL = 1e-4
CONTROL_FACTOR = 4.0
BF16_FACTOR = 2.0
PERTURB = 2e-7
LR = 1e-3

#: Parameters with no gradient: the head's conv biases before BatchNorm.
ZERO_GRAD = tuple(f"params/refine/conv{i}/bias" for i in range(4))


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        out.update(_flat(value, name) if isinstance(value, dict) else {name: np.asarray(value)})
    return out


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Few intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _holdout():
    return checkpoint.load_variables(str(WEIGHTS / "panet_holdout.msgpack"))


@functools.lru_cache(maxsize=None)
def _batch(n=4):
    images = train.synthetic_images(np.random.default_rng(1), 2, 96, 96)
    return train.sample_batch_warped(np.random.default_rng(0), images, n)


def _jax_vars():
    return jax.tree.map(jnp.asarray, _holdout())


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jax_norm(x):
    return jax_panet.normalize_patches(jnp.asarray(x))


@functools.lru_cache(maxsize=None)
def _jax_apply(compute, method=None, train_mode=False):
    """A jitted JAX PANet apply (op by op, each primitive compiles alone)."""
    model = jax_panet.PANet(compute)
    kwargs = {"method": method} if method is not None else {}
    if train_mode:
        kwargs.update(train=True, mutable=["batch_stats"])
    return jax.jit(lambda v, r, t: model.apply(v, r, t, **kwargs))


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX's initial variables for seed 0 (jitted init; the same draws)."""
    dummy = jnp.zeros((1, 33, 33, 3), jnp.float32)
    init = jax.jit(lambda key: jax_panet.PANet(jnp.float32).init(key, dummy, dummy))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def test_init_variables_have_flax_layout_and_distributions():
    """Leaves, shapes and dtypes of JAX's initial variables; lecun_normal
    kernels (truncated at 2 sigma, std sqrt(1 / fan_in)), zero biases,
    BatchNorm scale 1, bias 0, mean 0, var 1; a seed gives the same bytes."""
    want = _flat(_jax_init())
    got = _flat(panet.init_variables(0))
    assert list(got) == list(_flat(panet.to_jax_variables(
        train.load_model(_jax_init(), torch.float32, "cpu"))))
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        assert value.dtype == want[key].dtype and value.shape == want[key].shape, key
        if key.endswith("kernel"):
            std = (1.0 / np.prod(value.shape[:-1])) ** 0.5
            assert np.abs(value).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6), key
            if value.size >= 10_000:
                assert abs(value.std() / std - 1) < 0.02, key
        else:
            np.testing.assert_array_equal(value, want[key], err_msg=key)
    assert checkpoint.dumps(panet.init_variables(0)) == checkpoint.dumps(panet.init_variables(0))
    assert checkpoint.dumps(panet.init_variables(1)) != checkpoint.dumps(panet.init_variables(0))


def test_unfolded_eval_forward_matches_jax():
    ref, tgt, _ = _batch()
    want = np.asarray(_jax_apply(jnp.float32)(_jax_vars(), _jax_norm(ref), _jax_norm(tgt)))
    want12, want21 = _jax_apply(jnp.float32, jax_panet.PANet.forward_sym)(
        _jax_vars(), _jax_norm(ref), _jax_norm(tgt))
    port = train.load_model(_holdout(), torch.float32, "cpu").eval()
    with torch.no_grad():
        got = port(panet.normalize_patches(_t(ref)), panet.normalize_patches(_t(tgt)))
        g12, g21 = port.forward_sym(panet.normalize_patches(_t(ref)), panet.normalize_patches(_t(tgt)))
    np.testing.assert_allclose(got.numpy(), want, atol=EVAL_ATOL)
    np.testing.assert_allclose(g12.numpy(), np.asarray(want12), atol=EVAL_ATOL)
    np.testing.assert_allclose(g21.numpy(), np.asarray(want21), atol=EVAL_ATOL)
    # Running statistics are read, not written, in eval mode.
    assert checkpoint.dumps(panet.to_jax_variables(port)) == checkpoint.dumps(_holdout())
    with pytest.raises(ValueError, match="inference-only"):
        panet.PANet(torch.float32).forward_sym(_t(ref), _t(tgt), train=True)


def _train_forward(compute, ref, tgt):
    """JAX's and the port's train-mode forward_sym at one compute type:
    ((d12, d21), batch_stats) each."""
    (j12, j21), state = _jax_apply(compute, jax_panet.PANet.forward_sym, True)(
        _jax_vars(), _jax_norm(ref), _jax_norm(tgt))
    port = train.load_model(_holdout(), {jnp.float32: torch.float32,
                                         jnp.bfloat16: torch.bfloat16}[compute], "cpu")
    with torch.no_grad():
        p12, p21 = port.forward_sym(panet.normalize_patches(_t(ref)),
                                    panet.normalize_patches(_t(tgt)), train=True)
    jax_out = (np.asarray(j12, np.float32), np.asarray(j21, np.float32))
    port_out = (p12.float().numpy(), p21.float().numpy())
    return jax_out, _flat({"batch_stats": state["batch_stats"]}), port_out, \
        _flat({"batch_stats": panet.to_jax_variables(port)["batch_stats"]})


def test_unfolded_train_forward_and_batch_stats_match_jax():
    ref, tgt, _ = _batch()
    jax_out, jax_stats, port_out, port_stats = _train_forward(jnp.float32, ref, tgt)
    for got, want in zip(port_out, jax_out):
        np.testing.assert_allclose(got, want, atol=TRAIN_ATOL)
    assert jax_stats.keys() == port_stats.keys()
    before = _flat({"batch_stats": _holdout()["batch_stats"]})
    for key, want in jax_stats.items():
        assert not np.array_equal(want, before[key]), key  # the forward updated them
        np.testing.assert_allclose(port_stats[key], want, atol=STATS_RTOL * np.abs(want).max(),
                                   err_msg=key)


def test_bf16_train_forward_within_bf16_rounding():
    ref, tgt, delta = _batch()
    jax32, _, _, _ = _train_forward(jnp.float32, ref, tgt)
    jax16, _, port16, _ = _train_forward(jnp.bfloat16, ref, tgt)

    def loss(d12, d21):
        main = ((d12 + delta) ** 2).sum(-1).mean() + ((d21 - delta) ** 2).sum(-1).mean()
        return main + 0.1 * ((d12 + d21) ** 2).sum(-1).mean()

    bound = max(np.abs(a - b).max() for a, b in zip(jax16, jax32))
    assert bound > 0
    for got, want in zip(port16, jax16):
        assert np.abs(got - want).max() <= BF16_FACTOR * bound
    assert abs(loss(*port16) - loss(*jax16)) <= BF16_FACTOR * abs(loss(*jax16) - loss(*jax32))


@functools.lru_cache(maxsize=None)
def _jax_step():
    tx = optax.adam(LR)
    return tx, jax.jit(jax_train.make_train_step(tx, jnp.float32))


def _jax_steps(ref, tgt, delta, steps=2):
    tx, step = _jax_step()
    v = _jax_vars()
    state = jax_train.TrainState(v["params"], v["batch_stats"], tx.init(v["params"]), 0)
    losses = []
    for _ in range(steps):
        state, loss = step(state, jnp.asarray(ref), jnp.asarray(tgt), jnp.asarray(delta))
        losses.append(float(loss))
    return losses, _flat({"params": state.params, "batch_stats": state.batch_stats})


def _port_steps(ref, tgt, delta, steps=2, mkldnn=True):
    with torch.backends.mkldnn.flags(enabled=mkldnn):
        model = train.load_model(_holdout(), torch.float32, "cpu").train()
        optimizer, _ = train.make_optimizer(model, LR)
        losses = [float(train.train_step(model, optimizer, _t(ref), _t(tgt), _t(delta)))
                  for _ in range(steps)]
    return losses, _flat(panet.to_jax_variables(model))


def _groups(keys):
    return {
        "params": [k for k in keys if k.startswith("params") and k not in ZERO_GRAD],
        "zero_grad": list(ZERO_GRAD),
        "batch_stats": [k for k in keys if k.startswith("batch_stats")],
    }


def _relative(a, b, keys, start):
    """|a - b| over |b - start|, as norms over all leaves of ``keys``."""
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in keys)
    den = sum(float(np.sum((b[k].astype(np.float64) - start[k]) ** 2)) for k in keys)
    return (num / den) ** 0.5


def test_two_adam_steps_match_jax_within_the_controls():
    ref, tgt, delta = _batch()
    rng = np.random.default_rng(7)
    pert = lambda x: (x * (1 + PERTURB * rng.standard_normal(x.shape))).astype(np.float32)  # noqa: E731
    jax_losses, jax_state = _jax_steps(ref, tgt, delta)
    ctrl_losses, ctrl_state = _jax_steps(pert(ref), pert(tgt), delta)
    port_losses, port_state = _port_steps(ref, tgt, delta)
    route_losses, route_state = _port_steps(ref, tgt, delta, mkldnn=False)
    assert jax_state.keys() == port_state.keys()
    for k in range(2):
        control = max(abs(ctrl_losses[k] - jax_losses[k]), abs(route_losses[k] - port_losses[k]))
        assert abs(port_losses[k] - jax_losses[k]) <= CONTROL_FACTOR * control + 1e-9, k
    assert port_losses[1] < port_losses[0]
    start = _flat(_holdout())
    for name, keys in _groups(jax_state).items():
        got = _relative(port_state, jax_state, keys, start)
        control = max(_relative(ctrl_state, jax_state, keys, start),
                      _relative(route_state, port_state, keys, start))
        assert got <= CONTROL_FACTOR * control, (name, got, control)


@pytest.mark.parametrize("num_steps", [4, 256, 2000])
def test_schedule_matches_optax(num_steps):
    sched = optax.warmup_cosine_decay_schedule(
        0.0, LR, min(200, num_steps // 10 + 1), num_steps, LR * 0.02)
    counts = np.arange(num_steps + 3)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(counts)), np.float64)
    got = np.array([LR * train.lr_factor(int(c), num_steps) for c in counts])
    # optax evaluates in f32: where 1 + cos cancels near the end of the
    # decay its error is a few f32 spacings of the peak rate.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=4 * np.finfo(np.float32).eps * LR)
    assert got[0] == 0.0
    model = torch.nn.Linear(1, 1)
    optimizer, scheduler = train.make_optimizer(model, LR, num_steps)
    seen = []
    for _ in range(5):
        seen.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        scheduler.step()
    np.testing.assert_allclose(seen, got[:5], rtol=1e-12)


@pytest.mark.parametrize("sampler, kwargs", [
    ("sample_batch", {}),
    ("sample_batch_warped", {}),
    ("sample_batch_warped", {"occlusion_prob": 0.5}),
], ids=["plain", "warped", "warped_occluded"])
def test_samplers_bit_for_bit(sampler, kwargs):
    images = train.synthetic_images(np.random.default_rng(2), 3, 80, 120)
    images.append(np.zeros((30, 30, 3), np.float32))  # too small: skipped or redrawn
    got = getattr(train, sampler)(np.random.default_rng(3), images, 37, **kwargs)
    want = getattr(jax_train, sampler)(np.random.default_rng(3), images, 37, **kwargs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(
        train.synthetic_images(np.random.default_rng(4), 2, 64, 48)[1],
        jax_train.synthetic_images(np.random.default_rng(4), 2, 64, 48)[1])


def test_procedural_textures_and_corpus_match_jax(monkeypatch):
    monkeypatch.setattr(jax_corpus, "_text_texture", lambda rng, size: None)
    got = corpus.procedural_textures(np.random.default_rng(5), count=7, size=64)
    want = jax_corpus.procedural_textures(np.random.default_rng(5), count=7, size=64)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert corpus._text_texture(np.random.default_rng(0), 64) is None
    paths = corpus.discover_local_images()
    try:
        import sklearn  # noqa: F401
    except ImportError:
        return
    assert paths == jax_corpus.discover_local_images()
    if paths:
        got = corpus.load_corpus(max_images=1, include_textures=False)
        want = jax_corpus.load_corpus(max_images=1, include_textures=False)
        assert len(got) == len(want) == 1
        np.testing.assert_array_equal(got[0], want[0])


def test_train_run_matches_jax(monkeypatch, capsys):
    """Four steps of ``train`` (warm-up of one step at learning rate 0, then
    the cosine), both packages from JAX's initial variables for seed 0 (the
    initialisers patched: the port's, because jax.random's draws cannot be
    reproduced; JAX's, to its jitted form, which takes seconds where its op
    by op form takes twelve), held to the controls of the Adam-step test on
    the same run: JAX on its training images scaled by 1 + 2e-7 N(0, 1), and
    the port with oneDNN off.  At two pairs a batch the last BatchNorm
    averages four rows, where the fast variance's cancellation is at its
    worst, so the JAX control, which reaches the reductions, is the larger."""
    init = _jax_init()
    monkeypatch.setattr(jax_panet, "init_params", lambda key, dtype: init)
    monkeypatch.setattr(panet, "init_variables", lambda seed: init)
    kwargs = dict(num_steps=4, batch_size=2, seed=0, log_every=1)
    want = _flat(jax_train.train(compute_dtype=jnp.float32, **kwargs))
    jax_log = capsys.readouterr().out
    rng = np.random.default_rng(11)
    images = jax_train.synthetic_images
    monkeypatch.setattr(jax_train, "synthetic_images", lambda *a, **k: [
        (im * (1 + PERTURB * rng.standard_normal(im.shape))).astype(np.float32)
        for im in images(*a, **k)])
    jax_control = _flat(jax_train.train(compute_dtype=jnp.float32, **kwargs))
    capsys.readouterr()
    timing = {}
    got = _flat(train.train(compute_dtype=torch.float32, device="cpu", timing=timing, **kwargs))
    assert capsys.readouterr().out.count("[train] step") == jax_log.count("[train] step") == 4
    assert len(timing["losses"]) == 4 and timing["steps"] > 0
    with torch.backends.mkldnn.flags(enabled=False):
        route = _flat(train.train(compute_dtype=torch.float32, device="cpu", **kwargs))
    assert list(got) == list(want)
    start = _flat(init)
    for name, keys in _groups(want).items():
        err = _relative(got, want, keys, start)
        control = max(_relative(route, got, keys, start),
                      _relative(jax_control, want, keys, start))
        assert err <= CONTROL_FACTOR * control, (name, err, control)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        train.train(num_steps=4, device="cuda")


def test_evaluate_px_error_matches_jax():
    """The eval-mode forward in chunks of 128 (130 pairs: two chunks)."""
    batch = _batch(130)
    want = jax_train.evaluate_px_error(_jax_vars(), batch, jnp.float32)
    got = train.evaluate_px_error(_holdout(), batch, torch.float32, device="cpu")
    # |mean |a| - mean |b|| <= max |a - b|: sqrt(2) * 16 px per unit.
    assert abs(got - want) <= EVAL_ATOL * 16.0 * 2 ** 0.5
    assert 0.0 < got < 8.0


def test_cli_writes_a_checkpoint(tmp_path):
    out = str(tmp_path / "ckpt.msgpack")
    train.main(["--num_steps", "2", "--batch_size", "4", "--output", out, "--device", "cpu"])
    variables = checkpoint.load_variables(out)
    assert list(variables) == ["params", "batch_stats"]
    model = train.load_model(variables, torch.float32, "cpu")
    assert checkpoint.dumps(panet.to_jax_variables(model)) == pathlib.Path(out).read_bytes()
