"""The port's SIFT and DoH extractors (lfr_tpu_torch.ops.sift, .doh) against
lfr_tpu's on the CPU.

Stage by stage, both packages are fed the same arrays:
- ``_blur``: within BLUR_ULPS (torch's convolution sums the taps in
  another order than XLA's Eigen convolution: 1-2 ulp in 60% of pixels,
  4-5 at most, read here);
- ``_octave_candidates`` on JAX's own Gaussians and DoG: the same
  candidates, positions within POS_ATOL and scores within SCORE_RTOL, at
  most FMA_MARGIN_CANDIDATES without a partner either way (XLA may fuse
  the cofactor products into multiply-adds, which moves a candidate at a
  threshold's margin);
- ``_gradient_stack``: equal;
- orientation histograms and descriptors on the same gradients and
  keypoints: within HIST_RTOL of each histogram's peak and DESC_ATOL;
- ``collect_octave_features`` on JAX's blocks: equal;
- DoH's response stack on JAX's Gaussians: equal (the same operations,
  unfused in both).

End to end on the relief_mini fixture's DSC_0001 (360x480): the port's
keypoints against JAX's, matched within 1e-2 px, descriptors within 4e-3
(``eval.compare.feature_agreement``).  Each bound is the lesser of two
controls, recomputed here, less E2E_MARGIN: JAX against JAX on the view
with each pixel scaled by 1 + 2e-7 N(0, 1), and the port with oneDNN's
convolution against the port with PyTorch's own (the blur in another
order, as the two packages differ).  With JAX's blur in the port, the port
equals JAX on every keypoint, which shows that the blur is the only
difference that moves them; DoH's descriptors are then all JAX's, and
SIFT's agree at least as well as JAX's perturbation control.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.io import images as jax_images
from lfr_tpu.ops import doh as jax_doh
from lfr_tpu.ops import sift as jax_sift
from lfr_tpu.utils import synthetic
from lfr_tpu_torch.eval.compare import feature_agreement
from lfr_tpu_torch.ops import doh, sift

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DSC_0001 = os.path.join(ROOT, "tests", "fixtures", "eth3d_mini", "relief_mini", "images",
                        "dslr_images_undistorted", "DSC_0001.JPG")

BLUR_ULPS = 8
POS_ATOL = 1e-5
SCORE_RTOL = 1e-6
FMA_MARGIN_CANDIDATES = 2
HIST_RTOL = 1e-5
DESC_ATOL = 1e-5
E2E_MARGIN = 0.02
PERTURB = 2e-7


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))


@pytest.fixture(scope="module")
def gray():
    rng = np.random.default_rng(0)
    image = synthetic.textured_image(rng, 128, 160)
    return (image @ np.array([0.299, 0.587, 0.114]) / 255.0).astype(np.float32)


@pytest.fixture(scope="module")
def jax_octave(gray):
    """JAX's Gaussian stack and DoG of octave 0."""
    base, inc = sift._sift_increments()
    levels = [jax_sift._blur(jnp.asarray(gray), jax_sift._gaussian_kernel(base))]
    for s in inc:
        levels.append(jax_sift._blur(levels[-1], jax_sift._gaussian_kernel(s)))
    G = jnp.stack(levels)
    return G, G[1:] - G[:-1]


@pytest.fixture(scope="module")
def dsc_0001():
    rgb = jax_images.load_image_rgb(DSC_0001)
    gray = rgb @ np.array([0.299, 0.587, 0.114]) / 255.0
    rng = np.random.default_rng(1)
    return gray, gray * (1.0 + PERTURB * rng.standard_normal(gray.shape))


def test_blur_within_a_few_ulps(gray):
    base, inc = sift._sift_increments()
    for sigma in [base, *inc, 2.0]:
        k = sift._gaussian_kernel(sigma)
        np.testing.assert_array_equal(k, jax_sift._gaussian_kernel(sigma))
        want = np.asarray(jax_sift._blur(jnp.asarray(gray), k))
        got = sift._blur(_t(gray), k).numpy()
        assert _ulps(got, want).max() <= BLUR_ULPS, sigma


def test_octave_candidates_on_jax_arrays(jax_octave):
    G, D = jax_octave
    want = [np.asarray(x) for x in jax_sift._octave_candidates(G, D, top_k=1024)]
    got = [x.numpy() for x in sift._octave_candidates(_t(D), 1024)]
    jpos, tpos = want[1][want[2]], got[1][got[2]]
    assert len(jpos) > 40
    from scipy.spatial import cKDTree

    for a, b, sa, sb in ((jpos, tpos, want[0][want[2]], got[0][got[2]]),
                         (tpos, jpos, got[0][got[2]], want[0][want[2]])):
        dist, idx = cKDTree(b).query(a)
        close = dist <= POS_ATOL
        assert (~close).sum() <= FMA_MARGIN_CANDIDATES
        np.testing.assert_allclose(sa[close], sb[idx[close]], rtol=SCORE_RTOL)


def test_gradient_stack_equal(jax_octave):
    G, _ = jax_octave
    np.testing.assert_array_equal(sift._gradient_stack(_t(G)).numpy(),
                                  np.asarray(jax_sift._gradient_stack(G)))


def test_orientation_and_descriptors_on_the_same_inputs(jax_octave):
    G, D = jax_octave
    _, pos, valid = (np.asarray(x) for x in jax_sift._octave_candidates(G, D, top_k=1024))
    pos = pos[valid]
    ij = pos[:, 1:3]
    sigma = (sift.SIGMA0 * 2.0 ** ((pos[:, 0] - 1.0) / sift.NUM_SCALES)).astype(np.float32)
    level = np.clip(np.round(pos[:, 0] - 1.0).astype(np.int64) + 1, 1, sift.NUM_SCALES) - 1
    onehot = np.eye(sift.NUM_SCALES, dtype=np.float32)[level]
    grad = np.asarray(jax_sift._gradient_stack(G))

    want = np.asarray(jax_sift._orientation_histogram(grad, ij, sigma, onehot))
    got = sift._orientation_histogram(_t(grad), _t(ij), _t(sigma), _t(level)).numpy()
    assert (np.abs(got - want).max(1) <= HIST_RTOL * want.max(1)).all()

    theta = np.linspace(0.0, 2 * np.pi, len(ij), endpoint=False).astype(np.float32)
    want = np.asarray(jax_sift._descriptors(grad, ij, sigma, theta, onehot))
    got = sift._descriptors(_t(grad), _t(ij), _t(sigma), _t(theta), _t(level)).numpy()
    np.testing.assert_allclose(got, want, atol=DESC_ATOL)


def test_collect_octave_features_equal(gray):
    img, true_h, true_w, n_oct = jax_sift.prepare_image(gray[:120, :150], 16.0)
    meta, desc = (np.asarray(x) for x in jax_sift._sift_pyramid(img, n_oct, 512))
    sizes = jax_sift.octave_sizes(n_oct, 512)
    assert sizes == sift.octave_sizes(n_oct, 512)
    for max_features in (4096, 50):
        want = jax_sift.collect_octave_features(meta, desc, sizes, true_h, true_w, max_features)
        got = sift.collect_octave_features(meta, desc, sizes, true_h, true_w, max_features)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(got[0]) == 50


def test_doh_response_stack_equal(gray):
    sigmas = doh._sigmas()
    levels = [jax_sift._blur(jnp.asarray(gray), jax_sift._gaussian_kernel(doh.SIGMA0))]
    for i in range(1, len(sigmas)):
        inc = float(np.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-8)))
        levels.append(jax_sift._blur(levels[-1], jax_sift._gaussian_kernel(inc)))
    G = jnp.stack(levels)
    want = jnp.stack([jax_doh._det_hessian(G[i], s) for i, s in enumerate(sigmas)])
    np.testing.assert_array_equal(doh._response_stack(_t(G)).numpy(), np.asarray(want))


def _bounds(jax_fn, port_fn, view, perturbed):
    """JAX's features of the view, the port's, the two controls' bound and
    the perturbation control."""
    want = jax_fn(view)
    port = port_fn(view, device="cpu")
    with torch.backends.mkldnn.flags(enabled=False):
        port_conv = port_fn(view, device="cpu")
    controls = [feature_agreement(want, jax_fn(perturbed)), feature_agreement(port, port_conv)]
    bound = {k: min(c[k] for c in controls) - E2E_MARGIN for k in ("matched", "descriptors")}
    return want, port, bound, controls[0]


@pytest.mark.parametrize("name", ["sift", "doh"])
def test_extract_matches_jax_within_the_controls(name, dsc_0001, monkeypatch):
    jax_fn, port_fn = {"sift": (jax_sift.extract_sift, sift.extract_sift),
                       "doh": (jax_doh.extract_doh, doh.extract_doh)}[name]
    view, perturbed = dsc_0001
    want, got, bound, perturbation = _bounds(jax_fn, port_fn, view, perturbed)
    assert len(want[0]) > 300
    agree = feature_agreement(want, got)
    assert agree["matched"] >= bound["matched"], (agree, bound)
    assert agree["descriptors"] >= bound["descriptors"], (agree, bound)
    np.testing.assert_allclose(np.linalg.norm(got[2], axis=1), 1.0, atol=1e-5)

    # With JAX's blur, every keypoint of the port is JAX's, and so is every
    # DoH descriptor.  SIFT's orientation histograms sum in another order
    # (HIST_RTOL), so a keypoint whose two highest bins tie within that
    # rounding may take the other one (1 of 391 here): its descriptors agree
    # at least as well as JAX's own do under the perturbation.
    monkeypatch.setattr(sift, "_blur", lambda image, kernel: _t(
        jax_sift._blur(jnp.asarray(image.numpy()), kernel)))
    same = feature_agreement(want, port_fn(view, device="cpu"))
    assert same["matched"] == 1.0 and same["keypoints"][0] == same["keypoints"][1], same
    assert same["descriptors"] >= (1.0 if name == "doh" else perturbation["descriptors"]), (
        same, perturbation)


def test_entry_points_raise_without_a_card(monkeypatch, gray):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (sift.extract_sift, sift.dispatch_sift, doh.extract_doh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(gray)
