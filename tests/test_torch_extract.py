"""The port's ``extract`` (lfr_tpu_torch.pipelines.extract_features) against
lfr_tpu's on a copy of the relief_mini fixture (JPEG, nested image
directory) on the CPU, at ``max_edge`` 240 (a factor-2 downscale):
- both packages write the same files, and skip a stray non-image; each
  written SIFT file agrees with JAX's (keypoints matched within MATCH_PX
  of the extraction's pixels, descriptors within DESC_ATOL) at least as
  well as the lesser of two controls on the resized view less E2E_MARGIN,
  as in test_torch_sift: JAX against JAX on the view with each pixel
  scaled by 1 + PERTURB N(0, 1), and the port with oneDNN's convolution
  against the port with PyTorch's own;
- SIFT's and DoH's scale columns are rescaled to original pixels and
  SURF's is not, against the port's own extractor on the resized image;
- the pipelined SIFT run (three images deep) writes what one image at a
  time gives;
- a progressive JPEG raises and names the file (the port decodes baseline
  JPEG only; the JAX package would decode it with cv2);
- ``python -m lfr_tpu_torch extract --help`` lists sift, surf and doh, and
  without a card the default device raises.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from lfr_tpu.ops import sift as jax_sift
from lfr_tpu.pipelines import extract_features as jax_extract
from lfr_tpu_torch.eval.compare import feature_agreement
from lfr_tpu_torch.io import features as features_io
from lfr_tpu_torch.io import images as images_io
from lfr_tpu_torch.ops import sift
from lfr_tpu_torch.pipelines import extract_features

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "eth3d_mini", "relief_mini", "images")
NESTED = "dslr_images_undistorted"
MAX_EDGE = 240
MATCH_PX = 1e-2
DESC_ATOL = 4e-3
E2E_MARGIN = 0.02
PERTURB = 2e-7


def _copy(tmp_path, name):
    out = str(tmp_path / name)
    shutil.copytree(FIXTURE, out)
    with open(os.path.join(out, NESTED, "notes.txt"), "w") as fh:
        fh.write("not an image\n")
    return out


def _written(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_extract_directory_writes_what_jax_writes(tmp_path):
    roots = {pkg: _copy(tmp_path, pkg) for pkg in ("jax", "port")}
    assert jax_extract.extract_directory(roots["jax"], "sift", max_edge=MAX_EDGE,
                                         verbose=False) == 3
    assert extract_features.extract_directory(roots["port"], "sift", max_edge=MAX_EDGE,
                                              verbose=False, device="cpu") == 3
    assert _written(roots["port"]) == _written(roots["jax"])
    rng = np.random.default_rng(2)
    for name in ("DSC_0001.JPG", "DSC_0002.JPG", "DSC_0003.JPG"):
        got, want = (features_io.load_features(os.path.join(roots[p], NESTED, name), "sift")
                     for p in ("port", "jax"))
        image = images_io.load_image_rgb(os.path.join(FIXTURE, NESTED, name))
        factor = max(image.shape[:2]) / MAX_EDGE
        view = images_io.resize_by_factor(image, factor) @ np.array([0.299, 0.587, 0.114]) / 255.0
        perturbed = view * (1.0 + PERTURB * rng.standard_normal(view.shape))
        with torch.backends.mkldnn.flags(enabled=False):
            port_conv = sift.extract_sift(view, device="cpu")
        controls = [
            feature_agreement(jax_sift.extract_sift(view), jax_sift.extract_sift(perturbed),
                              MATCH_PX, DESC_ATOL),
            feature_agreement(sift.extract_sift(view, device="cpu"), port_conv,
                              MATCH_PX, DESC_ATOL)]
        # The files hold original pixels: MATCH_PX of the extraction is
        # MATCH_PX * factor there.
        agree = feature_agreement((want.keypoints, want.scores, want.descriptors),
                                  (got.keypoints, got.scores, got.descriptors),
                                  MATCH_PX * factor, DESC_ATOL)
        assert len(want.keypoints) > 100
        for k in ("matched", "descriptors"):
            assert agree[k] >= min(c[k] for c in controls) - E2E_MARGIN, (name, agree, controls)


@pytest.mark.parametrize("method", ["sift", "surf", "doh"])
def test_extract_directory_rescales_to_original_pixels(tmp_path, method):
    root = _copy(tmp_path, "port")
    timing = {}
    assert extract_features.extract_directory(root, method, max_edge=MAX_EDGE, verbose=False,
                                              device="cpu", timing=timing) == 3
    assert sorted(timing) == (["collect", "decode", "write"] if method == "surf"
                              else ["collect", "decode", "dispatch", "write"])
    extractor = extract_features.EXTRACTORS[method]
    for name in ("DSC_0001.JPG", "DSC_0002.JPG"):
        path = os.path.join(root, NESTED, name)
        image = images_io.load_image_rgb(path)
        factor = max(image.shape[:2]) / MAX_EDGE
        kp, scores, desc = extractor(images_io.resize_by_factor(image, factor), 4096, "cpu")
        saved = features_io.load_features(path, method)
        np.testing.assert_array_equal(saved.keypoints[:, :2], kp[:, :2] * factor)
        scale = kp[:, 2] * (1.0 if method == "surf" else factor)
        np.testing.assert_array_equal(saved.keypoints[:, 2], scale)
        np.testing.assert_array_equal(saved.keypoints[:, 3], kp[:, 3])
        np.testing.assert_array_equal(saved.descriptors, desc)
        np.testing.assert_array_equal(saved.scores, scores)


def test_progressive_jpeg_raises_with_its_name(tmp_path):
    root = _copy(tmp_path, "port")
    bad = os.path.join(root, NESTED, "DSC_0004.JPG")
    Image.open(os.path.join(root, NESTED, "DSC_0001.JPG")).save(bad, progressive=True)
    with pytest.raises(ValueError, match="DSC_0004.JPG.*progressive"):
        extract_features.extract_directory(root, "sift", max_edge=MAX_EDGE, verbose=False,
                                           device="cpu")


def test_cli_help_lists_the_extractors():
    env = dict(os.environ, PYTHONPATH=ROOT)
    top = subprocess.run([sys.executable, "-m", "lfr_tpu_torch"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert top.returncode == 0 and "  extract " in top.stdout
    out = subprocess.run([sys.executable, "-m", "lfr_tpu_torch", "extract", "--help"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    for word in ("sift", "surf", "doh", "--device", "--max_edge", "--image_path"):
        assert word in out.stdout


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = _copy(tmp_path, "port")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_features.extract_directory(root, "sift", verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_features.main(["--image_path", root, "--method_name", "surf"])
    assert not any(f.endswith((".sift", ".surf")) for f in _written(root))
