"""TwoViewRefiner in the port against lfr_tpu's, f32 on the CPU.

Tolerance: 1e-4 displacement units (1.6e-3 px).  Both sides run the same
f32 arithmetic; they differ in summation order (convs, interpolation), and
the coarse estimate re-centres the fine patches, so a 1e-6 coarse difference
moves the fine sampling slightly.  Measured: ~1e-6 units."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.models import checkpoint as jax_checkpoint
from lfr_tpu.pipelines import refinement as jax_refinement
from lfr_tpu.utils import synthetic
from lfr_tpu_torch.models import checkpoint
from lfr_tpu_torch.pipelines import refinement

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "weights" / "panet_cpu.msgpack"
ATOL = 1e-4


@pytest.fixture(scope="module")
def variables():
    return checkpoint.load_variables(str(WEIGHTS)), jax_checkpoint.load_variables(str(WEIGHTS))


def _both(variables, mode, batch_size, *args):
    ours, theirs = variables
    got = refinement.TwoViewRefiner(
        ours, batch_size=batch_size, compute_dtype=torch.float32, fine_mode=mode, device="cpu"
    ).refine_matches(*args)
    want = jax_refinement.TwoViewRefiner(
        variables=theirs, batch_size=batch_size, compute_dtype=jnp.float32, fine_mode=mode
    ).refine_matches(*args)
    return got, want


@pytest.mark.parametrize("mode", ["grid", "crop"])
def test_refine_matches_matches_jax(variables, mode):
    rng = np.random.default_rng(21)
    img1, img2 = synthetic.shifted_pair(rng, 96, 128, (2, -1))
    n = 12  # two chunks of 8
    kps1 = np.stack([rng.uniform(5, 123, n), rng.uniform(5, 91, n)], axis=1)
    kps2 = kps1 + rng.uniform(-1.5, 1.5, (n, 2))
    matches = np.stack([np.arange(n), rng.permutation(n)], axis=1)
    (g12, g21), (w12, w21) = _both(variables, mode, 8, img1, kps1, img2, kps2, matches)
    assert g12.shape == (n, 3, 3, 2) and g12.dtype == np.float32
    np.testing.assert_allclose(g12, w12, atol=ATOL)
    np.testing.assert_allclose(g21, w21, atol=ATOL)


def test_mismatched_image_sizes_match_jax(variables):
    """Images of different shapes are harmonized to one padded shape; the
    extractors clamp their windows to it, as in the JAX path."""
    rng = np.random.default_rng(13)
    img1 = synthetic.textured_image(rng, 100, 150)
    img2 = synthetic.textured_image(rng, 60, 90)
    n = 6
    kp1 = np.stack([rng.uniform(2, 148, n), rng.uniform(2, 98, n)], axis=1)
    kp2 = np.stack([rng.uniform(2, 88, n), rng.uniform(2, 58, n)], axis=1)
    matches = np.stack([np.arange(n), np.arange(n)], axis=1)
    (g12, g21), (w12, w21) = _both(variables, "crop", 8, img1, kp1, img2, kp2, matches)
    assert np.isfinite(g12).all() and np.isfinite(g21).all()
    np.testing.assert_allclose(g12, w12, atol=ATOL)
    np.testing.assert_allclose(g21, w21, atol=ATOL)


def test_async_prepared_and_chunked_equal_one_call(variables):
    ours, _ = variables
    rng = np.random.default_rng(5)
    img1, img2 = synthetic.shifted_pair(rng, 64, 80, (1, 2))
    n = 7
    kps = np.stack([rng.uniform(20, 60, n), rng.uniform(20, 44, n)], axis=1)
    matches = np.stack([np.arange(n), np.arange(n)], axis=1)
    whole = refinement.TwoViewRefiner(ours, batch_size=16, compute_dtype=torch.float32,
                                      device="cpu")
    chunked = refinement.TwoViewRefiner(ours, batch_size=3, compute_dtype=torch.float32,
                                        device="cpu")
    want = whole.refine_matches(img1, kps, img2, kps, matches)
    p1 = refinement.prepare_image(img1, "cpu")
    p2 = refinement.prepare_image(img2, "cpu")
    assert refinement.prepare_image(p1, "cpu") is p1
    handles = [chunked.refine_matches_async(p1, kps, p2, kps, matches) for _ in range(2)]
    for got in map(chunked.resolve_refined, handles):
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)


def test_empty_matches_and_bad_arguments(variables):
    ours, _ = variables
    ref = refinement.TwoViewRefiner(ours, batch_size=4, compute_dtype=torch.float32, device="cpu")
    img = np.zeros((40, 40, 3), np.uint8)
    g12, g21 = ref.refine_matches(img, np.zeros((0, 2)), img, np.zeros((0, 2)),
                                  np.zeros((0, 2), np.int64))
    assert g12.shape == (0, 3, 3, 2) and g21.shape == (0, 3, 3, 2)
    with pytest.raises(ValueError, match="fine_mode"):
        refinement.TwoViewRefiner(ours, fine_mode="patch", device="cpu")
    with pytest.raises(ValueError, match="variables"):
        refinement.TwoViewRefiner(None, device="cpu")


def test_default_device_is_cuda_and_never_falls_back(variables):
    ours, _ = variables
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        refinement.TwoViewRefiner(ours)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        refinement.prepare_image(np.zeros((8, 8, 3), np.uint8))


def test_image_prep_matches_jax():
    rng = np.random.default_rng(2)
    img = synthetic.textured_image(rng, 50, 70)
    for up in (False, True):
        ours = refinement._DeviceImage(img, torch.device("cpu"), upsample=up)
        theirs = jax_refinement._DeviceImage(img, upsample=up)
        assert ours.offset == theirs.offset
        np.testing.assert_allclose(ours.array.numpy(), np.asarray(theirs.array), atol=1e-4)
    padded, hw = refinement.pad_image(img)
    want, want_hw = jax_refinement.pad_image(img)
    np.testing.assert_array_equal(padded, want)
    np.testing.assert_array_equal(hw, want_hw)
