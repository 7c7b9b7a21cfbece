"""Per-pair matching + refinement and the cross-pair stream in the port,
against lfr_tpu's, f32 on the CPU.

Matches must be identical; flow grids agree within 1e-4 displacement units
(the tolerance of tests/test_torch_refinement.py: the same f32 arithmetic in
another summation order).  The port's stream must equal its own per-pair
path within 1e-5 (the same arithmetic on other batch compositions)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.models import checkpoint as jax_checkpoint
from lfr_tpu.pipelines import refinement as jax_refinement
from lfr_tpu.pipelines import stream as jax_stream
from lfr_tpu.utils import synthetic
from lfr_tpu_torch.models import checkpoint
from lfr_tpu_torch.pipelines import refinement, stream

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "weights" / "panet_cpu.msgpack"
ATOL = 1e-4
SELF_ATOL = 1e-5


def _scene(seed=11):
    """Five crops of one canvas (two sizes, so the image stack grows) with
    planted keypoints: each view holds 16 of 20 canvas points."""
    rng = np.random.default_rng(seed)
    canvas = synthetic.textured_image(rng, 140, 190)
    shapes = [(96, 128), (96, 128), (112, 150), (112, 150), (96, 128)]
    offsets = [(0, 0), (4, 8), (12, 20), (20, 28), (28, 12)]
    points = np.stack([rng.uniform(40, 120, 20), rng.uniform(40, 88, 20)], axis=1)
    desc = rng.standard_normal((20, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    views = []
    for (h, w), (oy, ox) in zip(shapes, offsets):
        ids = rng.choice(20, 16, replace=False)
        d = desc[ids] + 0.05 * rng.standard_normal((16, 128)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        kps = (points[ids] - np.array([ox, oy])).astype(np.float32)
        views.append((canvas[oy : oy + h, ox : ox + w].copy(), kps, d))
    return views


#: Pairs that cycle through all five images: with four stack slots, every
#: pair from the fourth on evicts an image.
PAIRS = [(0, 1), (2, 3), (4, 0), (1, 2), (3, 4)]


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def refiners():
    """One port and one JAX refiner per fine mode, shared by the module so
    that each JAX program compiles once."""
    ours = checkpoint.load_variables(str(WEIGHTS))
    theirs = jax_checkpoint.load_variables(str(WEIGHTS))
    out = {}
    for mode in ("crop", "grid"):
        out[mode] = (
            refinement.TwoViewRefiner(ours, batch_size=16, compute_dtype=torch.float32,
                                      fine_mode=mode, device="cpu"),
            jax_refinement.TwoViewRefiner(variables=theirs, batch_size=16,
                                          compute_dtype=jnp.float32, fine_mode=mode),
        )
    return out


def _per_pair(ref, views, pairs, prepare):
    out = []
    for i, j in pairs:
        (im1, kp1, d1), (im2, kp2, d2) = views[i], views[j]
        out.append(ref.finalize_pair(ref.process_pair(
            prepare(im1), kp1, d1, prepare(im2), kp2, d2, "ratio", 0.8)))
    return out


def _assert_same(got, want, atol):
    m, s, g12, g21 = got
    wm, ws, w12, w21 = want
    np.testing.assert_array_equal(m, wm)
    assert m.dtype == np.int64
    np.testing.assert_allclose(s, ws, atol=1e-6, rtol=0)
    np.testing.assert_allclose(g12, w12, atol=atol, rtol=0)
    np.testing.assert_allclose(g21, w21, atol=atol, rtol=0)


@pytest.mark.parametrize("mode", ["crop", "grid"])
def test_process_pair_matches_jax(scene, refiners, mode):
    ours, theirs = refiners[mode]
    pairs = PAIRS[:2]
    got = _per_pair(ours, scene, pairs, lambda im: refinement.prepare_image(im, "cpu"))
    want = _per_pair(theirs, scene, pairs, jax_refinement.prepare_image)
    for g, w in zip(got, want):
        assert len(g[0]) >= 8
        _assert_same(g, w, ATOL)


def _run_stream(module, ref, views, prepare, monkeypatch):
    """Stream PAIRS with an empty pair after the first, refine batches of 16
    rows (pairs split across batches) and four image and descriptor slots."""
    monkeypatch.setattr(module, "DESC_BUDGET_BYTES", 4 * 256 * 128 * 4)
    st = module.MatchRefineStream(ref, refine_batch=16, stack_budget_bytes=1)
    preps = [prepare(im) for im, _, _ in views]
    metas = []
    for k, (i, j) in enumerate(PAIRS):
        (_, kp1, d1), (_, kp2, d2) = views[i], views[j]
        st.add_pair(("pair", k), f"im{i}", preps[i], kp1, d1, f"im{j}", preps[j], kp2, d2,
                    "ratio", 0.8)
        metas.append(("pair", k))
        if k == 0:
            st.add_empty_pair(("empty", k))
            metas.append(("empty", k))
    out = list(st.ready()) + list(st.flush())
    assert [meta for meta, _ in out] == metas
    assert st.refined_rows == sum(len(p[0]) for _, p in out)
    return [payload for meta, payload in out if meta[0] == "pair"], out[1][1]


@pytest.mark.parametrize("mode", ["crop", "grid"])
def test_stream_matches_per_pair_and_jax(scene, refiners, mode, monkeypatch):
    ours, theirs = refiners[mode]
    got, empty = _run_stream(stream, ours, scene,
                             lambda im: refinement.prepare_image(im, "cpu"), monkeypatch)
    assert empty[0].shape == (0, 2) and empty[2].shape == (0, 3, 3, 2)
    per_pair = _per_pair(ours, scene, PAIRS, lambda im: refinement.prepare_image(im, "cpu"))
    want, _ = _run_stream(jax_stream, theirs, scene, jax_refinement.prepare_image, monkeypatch)
    assert sum(len(g[0]) for g in got) > 3 * 16  # several batches, pairs split across them
    for g, p, w in zip(got, per_pair, want):
        _assert_same(g, p, SELF_ATOL)
        _assert_same(g, w, ATOL)


def test_stream_write_slot_zero_extends():
    stack = torch.full((2, 4, 5, 3), 7.0)
    stream.MatchRefineStream._write_slot(stack, 1, torch.ones(2, 3, 3))
    assert stack[1, :2, :3].eq(1).all() and stack[1, 2:].eq(0).all() and stack[1, :, 3:].eq(0).all()
    assert stack[0].eq(7).all()
