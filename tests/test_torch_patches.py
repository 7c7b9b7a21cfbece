"""Patch/crop extractors and pyr_up in the port against lfr_tpu, f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.ops import image_ops as jax_image_ops
from lfr_tpu.ops import patches as jax_patches
from lfr_tpu_torch.ops import image_ops, patches

#: Both sides do the same f32 arithmetic; only the summation order of the
#: two interpolation products may differ (values up to 255).
ATOL = 2e-3


def _image(seed, h=90, w=110):
    return np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.float32)


def _centers(h, w):
    # Interior, fractional, and near/over every border so that the window
    # origin clamps (lfr_tpu/ops/patches.py:134-136).
    return np.array(
        [[45.3, 55.8], [20.0, 20.0], [1.2, 2.7], [h - 1.5, w - 0.25], [-4.0, 60.0],
         [50.5, w + 3.0], [0.0, 0.0], [h / 2.0, 17.49]],
        np.float32,
    )


def test_extract_patches_separable():
    img = _image(0)
    ij = _centers(*img.shape[:2])
    want = np.asarray(jax_patches.extract_patches_separable(jnp.asarray(img), jnp.asarray(ij)))
    got = patches.extract_patches_separable(torch.from_numpy(img), torch.from_numpy(ij))
    assert tuple(got.shape) == (8, 33, 33, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("grid_step", [16, 8])
def test_extract_patch_grid_separable(grid_step):
    img = _image(1)
    ij = _centers(*img.shape[:2])
    want = np.asarray(
        jax_patches.extract_patch_grid_separable(jnp.asarray(img), jnp.asarray(ij), grid_step)
    )
    got = patches.extract_patch_grid_separable(
        torch.from_numpy(img), torch.from_numpy(ij), grid_step
    )
    assert tuple(got.shape) == (8, 9, 33, 33, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("crop_size", [65, 33])
def test_extract_crops_unit(crop_size):
    img = _image(2)
    ij = _centers(*img.shape[:2])
    want = np.asarray(jax_patches.extract_crops_unit(jnp.asarray(img), jnp.asarray(ij), crop_size))
    got = patches.extract_crops_unit(torch.from_numpy(img), torch.from_numpy(ij), crop_size)
    assert tuple(got.shape) == (8, crop_size, crop_size, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("shape", [(24, 31, 3), (7, 5, 3)])
def test_pyr_up(shape):
    img = np.random.default_rng(3).integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(jax_image_ops.pyr_up(jnp.asarray(img)))
    got = image_ops.pyr_up(torch.from_numpy(img))
    assert tuple(got.shape) == (2 * shape[0], 2 * shape[1], 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize(
    "extract, args",
    [
        ("extract_patches_separable", (33,)),
        ("extract_patch_grid_separable", (16, 33)),
        ("extract_crops_unit", (65,)),
    ],
    ids=["patches", "grid", "crops"],
)
def test_stacked_img_idx_mode_matches_jax(extract, args):
    """Each center reads its own image of an (S, H, W, 3) stack."""
    rng = np.random.default_rng(4)
    stack = rng.uniform(0, 255, (3, 90, 110, 3)).astype(np.float32)
    ij = _centers(90, 110)
    idx = rng.integers(0, 3, len(ij)).astype(np.int32)
    want = np.asarray(getattr(jax_patches, extract)(
        jnp.asarray(stack), jnp.asarray(ij), *args, img_idx=jnp.asarray(idx)))
    got = getattr(patches, extract)(
        torch.from_numpy(stack), torch.from_numpy(ij), *args, img_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    for n in range(len(ij)):
        single = getattr(patches, extract)(
            torch.from_numpy(stack[idx[n]]), torch.from_numpy(ij[n : n + 1]), *args)
        np.testing.assert_array_equal(got[n].numpy(), single[0].numpy())


def test_reflect_coord_and_sample_bilinear():
    """SIFT's gradient sampler: reflection at the edge pixels' centres, four
    taps; inside and far outside the image (several reflection periods)."""
    img = _image(4, 23, 31)
    rng = np.random.default_rng(5)
    ij = rng.uniform(-70.0, 90.0, (6, 40, 2)).astype(np.float32)
    for size in (23, 31, 1):
        np.testing.assert_array_equal(
            patches.reflect_coord(torch.from_numpy(ij[..., 0]), size).numpy(),
            np.asarray(jax_patches.reflect_coord(jnp.asarray(ij[..., 0]), size)))
    want = np.asarray(jax_patches.sample_bilinear(jnp.asarray(img), jnp.asarray(ij)))
    got = patches.sample_bilinear(torch.from_numpy(img), torch.from_numpy(ij)).numpy()
    assert got.shape == (6, 40, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("margin", [96, 5])
def test_reflect_pad_image_matches_jax(margin):
    """Reflect-101 padding, the margin capped below the image size."""
    img = _image(6, 23, 40)
    want = jax_patches.reflect_pad_image(img, margin)
    got = patches.reflect_pad_image(img, margin)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert patches.effective_margin(img, margin) == jax_patches.effective_margin(img, margin)


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded_with_size"])
def test_extract_patches_matches_jax(padded):
    """The four-tap patch extractor, on an image and on a zero-padded copy
    whose valid extent is given by ``size``."""
    img = _image(7, 50, 61)
    ij = _centers(*img.shape[:2])
    size = None
    if padded:
        img = np.pad(img, ((0, 14), (0, 3), (0, 0)))
        size = (50, 61)
    want = np.asarray(jax_patches.extract_patches(
        jnp.asarray(img), jnp.asarray(ij), size=None if size is None else jnp.asarray(size)))
    got = patches.extract_patches(torch.from_numpy(img), torch.from_numpy(ij), size=size)
    assert tuple(got.shape) == (8, 33, 33, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(
        patches.patch_offsets(33).numpy(), np.asarray(jax_patches.patch_offsets(33)))
