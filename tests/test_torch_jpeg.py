"""The port's baseline JPEG decoder (lfr_tpu_torch.io.jpeg) against
``cv2.imread``, with which the JAX package reads its images: bit for bit
(tolerance 0) on the seven fixture images and on images that ``cv2``
encodes at 4:4:4, 4:2:2 and 4:2:0, in grayscale, with a restart interval,
at qualities 50 and 95, at an odd size (37 x 53, partial MCUs), and with
every EXIF orientation.  ``image_size`` and ``exif_focal_35mm`` follow PIL,
as the JAX package's dataset tools read them.

FIXTURE_SHA256 holds the SHA-256 of each fixture's decoded RGB array;
chip_smoke.py reads it from this file (the card's machine has no cv2) and
holds the port's decode there against it.
"""

import hashlib
import os
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from lfr_tpu.pipelines import dataset_tools as jax_dataset_tools
from lfr_tpu_torch.io import images, jpeg

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

FIXTURE_SHA256 = {
    "eth3d_mini/relief_mini/images/dslr_images_undistorted/DSC_0001.JPG": "5e42d648d36ff88b6b1440e3afee69307a7d398bc96f9caea896c3362c858fc6",
    "eth3d_mini/relief_mini/images/dslr_images_undistorted/DSC_0002.JPG": "814efad045aa27cb46bd5d32f035e20da5692a7947dbf6c3ade325c0840db776",
    "eth3d_mini/relief_mini/images/dslr_images_undistorted/DSC_0003.JPG": "53dd1b2d4c764e26e5b00a2c6f1d0ef2f6ee051ab154f911df4908ee4afb1478",
    "lfe_mini/Fountain_mini/images/000-view.jpg": "53ef7108e47b1927d9eee6472ea591e6fddd5aea4e2ba4423d749ed0226294fc",
    "lfe_mini/Fountain_mini/images/001-view.jpg": "f25f02cd53f4690566dc7a03e63daed82b25329b2ca40611632ee028c81bd96e",
    "lfe_mini/Fountain_mini/images/002-view.jpg": "3707590318243be90fff1f1eceb3f9fd2c301aa7d3117d204167737b514f5492",
    "lfe_mini/Fountain_mini/images/003-view.jpg": "efc749f3679dbefc607bb46ab531f0d938ee03adf181dc3133cc13219db4e120",
}


def _sha(image: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest()


def _photo(rng, h=53, w=37) -> np.ndarray:
    """A smooth colour image with edges (BGR, as cv2 writes it)."""
    small = (rng.random((h // 4 + 2, w // 4 + 2, 3)) * 255).astype(np.uint8)
    image = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    image[h // 3 : h // 2, w // 4 :] = (20, 200, 90)
    return image


@pytest.mark.parametrize("rel", sorted(FIXTURE_SHA256))
def test_fixture_decodes_as_cv2_and_matches_its_sha256(rel):
    path = os.path.join(FIXTURES, rel)
    got = images.load_image_rgb(path)
    want = cv2.imread(path)[:, :, ::-1]
    assert got.shape == want.shape == (360, 480, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert _sha(want) == FIXTURE_SHA256[rel]
    assert _sha(got) == FIXTURE_SHA256[rel]
    assert jpeg.image_size(path) == (480, 360)


ENCODINGS = {
    "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "420": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
    "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
    "quality50": [cv2.IMWRITE_JPEG_QUALITY, 50],
    "quality95": [cv2.IMWRITE_JPEG_QUALITY, 95],
}


@pytest.mark.parametrize("size", [(53, 37), (48, 64)])
@pytest.mark.parametrize("name", sorted(ENCODINGS) + ["gray"])
def test_encoded_jpeg_decodes_as_cv2(tmp_path, name, size):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    image = _photo(rng, *size)
    if name == "gray":
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(image, cv2.COLOR_BGR2GRAY))
    else:
        ok, buf = cv2.imencode(".jpg", image, ENCODINGS[name])
    assert ok
    path = str(tmp_path / "a.jpg")
    buf.tofile(path)
    got = images.load_image_rgb(path)
    want = cv2.imread(path)[:, :, ::-1]
    assert got.shape == want.shape == size + (3,)
    np.testing.assert_array_equal(got, want)


def _pil_jpeg(path, orientation=None, focal_ifd0=None, focal_sub_ifd=None, **save):
    """A JPEG written by PIL with the given EXIF entries (h 16 x w 24)."""
    image = Image.fromarray(_photo(np.random.default_rng(5), 16, 24)[:, :, ::-1].copy())
    exif = Image.Exif()
    if orientation is not None:
        exif[0x0112] = orientation
    if focal_ifd0 is not None:
        exif[0xA405] = focal_ifd0
    if focal_sub_ifd is not None:
        exif.get_ifd(0x8769)[0xA405] = focal_sub_ifd
    image.save(path, exif=exif, **save)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_applied_as_cv2(tmp_path, orientation):
    path = str(tmp_path / "o.jpg")
    _pil_jpeg(path, orientation=orientation)
    got = images.load_image_rgb(path)
    want = cv2.imread(path)[:, :, ::-1]
    np.testing.assert_array_equal(got, want)
    # The size stays the file's, unrotated, as PIL's Image.size.
    assert jpeg.image_size(path) == jax_dataset_tools._image_size(path) == (24, 16)


def test_exif_focal_reads_ifd0_only_as_the_jax_tools(tmp_path):
    """Orientation 6 with the focal in the Exif sub-IFD (where cameras
    store it): both packages see no focal prior (ROADMAP Queue 3)."""
    sub = str(tmp_path / "sub.jpg")
    _pil_jpeg(sub, orientation=6, focal_sub_ifd=50)
    assert cv2.imread(sub).shape[:2] == (24, 16)
    assert jpeg.exif_focal_35mm(sub, 24) is None
    assert jax_dataset_tools._exif_focal(sub, 24) is None
    ifd0 = str(tmp_path / "ifd0.jpg")
    _pil_jpeg(ifd0, focal_ifd0=50)
    assert jpeg.exif_focal_35mm(ifd0, 24) == jax_dataset_tools._exif_focal(ifd0, 24) == 50 / 35 * 24
    png = str(tmp_path / "a.png")
    Image.fromarray(np.zeros((4, 6, 3), np.uint8)).save(png)
    assert jpeg.exif_focal_35mm(png, 6) is None
    assert jpeg.image_size(png) == jax_dataset_tools._image_size(png) == (6, 4)


@pytest.mark.parametrize("mode", ["progressive", "cmyk"])
def test_unsupported_modes_raise_naming_the_mode(tmp_path, mode):
    path = str(tmp_path / "u.jpg")
    image = Image.fromarray(_photo(np.random.default_rng(6)))
    if mode == "progressive":
        image.save(path, progressive=True)
        match = "progressive"
    else:
        image.convert("CMYK").save(path)
        match = "CMYK"
    with pytest.raises(ValueError, match=match):
        images.load_image_rgb(path)
