"""The port's SURF extractor (lfr_tpu_torch.ops.surf) against lfr_tpu's on
the CPU.

Stage by stage, both packages are fed the same arrays:
- ``integral_image``: equal, bit for bit, at several sizes (the port sums
  in the order of XLA's CPU lowering of ``jnp.cumsum``: blocks of 16);
- ``det_hessian_map`` on the same integral: within DET_RTOL of the map's
  largest magnitude (XLA fuses some of the weighted box sums into
  multiply-adds; the port does not);
- ``_nms_and_interp`` on JAX's response maps: equal;
- ``_orientations`` within ORI_ATOL radians (``atan2`` and the window sums
  round differently), ``_descriptors`` within DESC_ATOL, on the same
  integral and keypoints.

End to end on DSC_0001, the port's keypoints against JAX's within a bound
set as in tests/test_torch_sift.py: the lesser of JAX against JAX on the
perturbed view and the port against itself through PyTorch's own
convolution (SURF has none: that control reads 100%), less E2E_MARGIN.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.io import images as jax_images
from lfr_tpu.ops import surf as jax_surf
from lfr_tpu.utils import synthetic
from lfr_tpu_torch.eval.compare import feature_agreement
from lfr_tpu_torch.ops import surf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DSC_0001 = os.path.join(ROOT, "tests", "fixtures", "eth3d_mini", "relief_mini", "images",
                        "dslr_images_undistorted", "DSC_0001.JPG")

DET_RTOL = 2e-6
ORI_ATOL = 1e-5
DESC_ATOL = 1e-5
E2E_MARGIN = 0.02
PERTURB = 2e-7


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def image255():
    rng = np.random.default_rng(0)
    rgb = synthetic.textured_image(rng, 144, 176)
    return (rgb @ np.array([0.114, 0.587, 0.299])).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 7), (16, 17), (33, 300), (144, 176)])
def test_integral_image_bit_exact(shape):
    x = (np.random.default_rng(3).random(shape) * 255).astype(np.float32)
    np.testing.assert_array_equal(surf.integral_image(_t(x)).numpy(),
                                  np.asarray(jax_surf.integral_image(jnp.asarray(x))))


def test_det_hessian_map_on_the_same_integral(image255):
    h, w = image255.shape
    ii = np.pad(np.asarray(jax_surf.integral_image(jnp.asarray(image255))), ((0, 240), (0, 240)),
                mode="edge")
    for size, stride in ((9, 1), (21, 2), (51, 4)):
        gh, gw = (h - size) // stride + 1, (w - size) // stride + 1
        want = np.asarray(jax_surf.det_hessian_map(jnp.asarray(ii), size, stride, gh, gw))
        got = surf.det_hessian_map(_t(ii), size, stride, gh, gw).numpy()
        assert np.abs(got - want).max() <= DET_RTOL * np.abs(want).max(), (size, stride)


def test_nms_orientations_and_descriptors_on_the_same_inputs(image255):
    h, w = image255.shape
    ii = np.asarray(jax_surf.integral_image(jnp.asarray(image255)))
    pyramid = jax_surf._response_pyramid(ii, h, w)
    want = jax_surf._nms_and_interp(pyramid, jax_surf.HESSIAN_THRESHOLD)
    got = surf._nms_and_interp(pyramid, surf.HESSIAN_THRESHOLD)
    np.testing.assert_array_equal(got, want)
    assert len(want) > 50

    xy = want[:, :2].astype(np.float32)
    scale = (1.2 * want[:, 2] / 9.0).astype(np.float32)
    theta = np.asarray(jax_surf._orientations(jnp.asarray(ii), xy, scale))
    got = surf._orientations(_t(ii), _t(xy), _t(scale)).numpy()
    diff = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - theta))))
    assert diff.max() <= ORI_ATOL
    want_d = np.asarray(jax_surf._descriptors(jnp.asarray(ii), xy, scale, theta))
    got_d = surf._descriptors(_t(ii), _t(xy), _t(scale), _t(theta)).numpy()
    np.testing.assert_allclose(got_d, want_d, atol=DESC_ATOL)


def test_extract_surf_matches_jax_within_the_controls():
    rgb = jax_images.load_image_rgb(DSC_0001)
    view = rgb @ np.array([0.299, 0.587, 0.114]) / 255.0
    rng = np.random.default_rng(1)
    perturbed = view * (1.0 + PERTURB * rng.standard_normal(view.shape))
    want = jax_surf.extract_surf(view)
    got = surf.extract_surf(view, device="cpu")
    with torch.backends.mkldnn.flags(enabled=False):
        port_conv = surf.extract_surf(view, device="cpu")
    controls = [feature_agreement(want, jax_surf.extract_surf(perturbed)),
                feature_agreement(got, port_conv)]
    agree = feature_agreement(want, got)
    assert len(want[0]) > 1000
    for key in ("matched", "descriptors"):
        assert agree[key] >= min(c[key] for c in controls) - E2E_MARGIN, (agree, controls)
    # OpenCV's keypoint conventions: size in pixels, angle in [0, 360).
    assert (got[0][:, 3] >= 0).all() and (got[0][:, 3] < 360).all()

    # The RGB path keeps the reference's BGR-weight gray quirk.
    got_rgb = surf.extract_surf(rgb, device="cpu")
    want_rgb = jax_surf.extract_surf(rgb)
    assert feature_agreement(want_rgb, got_rgb)["matched"] >= controls[0]["matched"] - E2E_MARGIN


def test_extract_surf_raises_without_a_card(monkeypatch, image255):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surf.extract_surf(image255)
