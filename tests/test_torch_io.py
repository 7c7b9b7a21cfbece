"""File formats and image loading in the port against lfr_tpu's.

MatchingFile / SolutionFile bytes must be identical to the JAX package's
numpy encoder (``use_native=False``) and each side must read the other's.
The PNG decoder must equal PIL's decode; the area resize matrices must equal
the JAX package's, and the downscale must give what OpenCV's INTER_AREA
(the reference's ``cv2.resize``) gives.  The tests may import cv2; the port
may not."""

import io
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lfr_tpu import config as jax_config
from lfr_tpu.io import features as jax_features
from lfr_tpu.io import images as jax_images
from lfr_tpu.io import match_list as jax_match_list
from lfr_tpu.io import protos as jax_protos
from lfr_tpu.ops import image_ops as jax_image_ops
from lfr_tpu.utils import synthetic
from lfr_tpu_torch import config
from lfr_tpu_torch.io import features, images, match_list, png, protos
from lfr_tpu_torch.ops import image_ops


def test_config_matches_jax():
    assert config.DUMP_INTERVAL == jax_config.DUMP_INTERVAL
    assert set(config.METHODS) == set(jax_config.METHODS)
    for name, method in config.METHODS.items():
        assert dataclass_tuple(method) == dataclass_tuple(jax_config.get_method(name))
    for hw in [(100, 120), (1334, 2000), (4000, 6000), (1600, 1601), (3000, 200)]:
        for caps in [(1600, 3200), (1600, 2800)]:
            assert config.downscale_factor(*hw, *caps) == jax_config.downscale_factor(*hw, *caps)
    with pytest.raises(ValueError, match="unknown"):
        config.get_method("orb")


def dataclass_tuple(m):
    return (m.name, m.max_edge, m.max_sum_edges, m.matcher, m.threshold)


def _pairs(seed):
    """Pairs that exercise the codec: multi-byte varints, zero floats
    (omitted fields), an empty pair, and an empty name."""
    rng = np.random.default_rng(seed)
    out = []
    for k, n in enumerate([5, 0, 40]):
        matches = rng.integers(0, 300000, (n, 2)).astype(np.uint32)
        if n:
            matches[:2] = [[0, 1], [127, 128]]  # one-byte varints and the first two-byte one
        sims = rng.uniform(-1, 1, n).astype(np.float32)
        grids = rng.standard_normal((2, n, 3, 3, 2)).astype(np.float32)
        grids[:, ::3, 1, 1] = 0.0  # zero cells: zero-length submessages
        sims[::4] = 0.0
        out.append(jax_protos.PairMatches(
            f"img_{k}.jpg" if k != 1 else "", 1.25 * k, f"dir/img_{k + 1}.png", 0.0 if k else 1.5,
            matches, sims, grids[0], grids[1],
        ))
    return out


def _port_pairs(pairs):
    return [protos.PairMatches(p.image_name1, p.fact1, p.image_name2, p.fact2, p.matches,
                               p.similarities, p.disp1, p.disp2) for p in pairs]


def _assert_pairs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.image_name1, g.fact1, g.image_name2, g.fact2) == (
            w.image_name1, w.fact1, w.image_name2, w.fact2)
        for field in ("matches", "similarities", "disp1", "disp2"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
            assert getattr(g, field).dtype == getattr(w, field).dtype


def test_matching_file_bytes_identical_and_cross_decoded():
    pairs = _pairs(0)
    want = jax_protos.encode_matching_file(pairs, use_native=False)
    got = protos.encode_matching_file(_port_pairs(pairs))
    assert got == want
    _assert_pairs_equal(protos.decode_matching_file(want),
                        jax_protos.decode_matching_file(want, use_native=False))
    _assert_pairs_equal(jax_protos.decode_matching_file(got, use_native=False),
                        protos.decode_matching_file(got))


def test_matching_file_parts_and_solution_file(tmp_path):
    pairs = _port_pairs(_pairs(1))
    path = str(tmp_path / "m.pb")
    protos.write_matching_file(f"{path}.part.0", pairs[:2])
    protos.write_matching_file(f"{path}.part.1", pairs[2:])
    assert protos.matching_file_parts(path) == [f"{path}.part.0", f"{path}.part.1"]
    # The JAX package's read_matching_file takes its native decoder, which
    # gives an empty image_name1 the value of image_name2; decode with its
    # numpy route instead.
    want = []
    for part in jax_protos.matching_file_parts(path):
        with open(part, "rb") as fh:
            want += jax_protos.decode_matching_file(fh.read(), use_native=False)
    _assert_pairs_equal(protos.read_matching_file(path), want)
    with pytest.raises(FileNotFoundError):
        protos.read_matching_file(str(tmp_path / "none.pb"))

    rng = np.random.default_rng(2)
    sols = [
        protos.ImageSolution("a.png", 1.25, np.array([0, 5, 300000], np.uint32),
                             rng.standard_normal((3, 2)).astype(np.float32)),
        protos.ImageSolution("", 0.0, np.zeros(0, np.uint32), np.zeros((0, 2), np.float32)),
    ]
    jax_sols = [jax_protos.ImageSolution(s.image_name, s.fact, s.feature_indices,
                                         s.displacements) for s in sols]
    data = protos.encode_solution_file(sols)
    assert data == jax_protos.encode_solution_file(jax_sols)
    for g, w in zip(protos.decode_solution_file(data), jax_protos.decode_solution_file(data)):
        assert (g.image_name, g.fact) == (w.image_name, w.fact)
        np.testing.assert_array_equal(g.feature_indices, w.feature_indices)
        np.testing.assert_array_equal(g.displacements, w.displacements)


def test_features_and_match_lists_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    image = str(tmp_path / "a.png")
    kps = rng.uniform(0, 100, (7, 2))
    desc = rng.standard_normal((7, 16)).astype(np.float32)
    features.save_features(image, kps, desc, method_name="sift")
    got = features.load_features(image, "sift")
    want = jax_features.load_features(image, "sift")
    for field in ("keypoints", "scores", "descriptors"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.completed_keypoints(), want.completed_keypoints())
    assert list(features.list_images_with_features(str(tmp_path), "sift")) == list(
        jax_features.list_images_with_features(str(tmp_path), "sift"))

    names = [f"{i:03d}-x.jpg" for i in (0, 1, 2, 5, 9)]
    assert match_list.exhaustive_pairs(names) == jax_match_list.exhaustive_pairs(names)
    assert match_list.sequential_pairs(names, 3) == jax_match_list.sequential_pairs(names, 3)
    path = str(tmp_path / "pairs.txt")
    match_list.write_match_list(path, match_list.exhaustive_pairs(names))
    assert match_list.read_match_list(path) == jax_match_list.read_match_list(path)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(image: np.ndarray, color: int) -> bytes:
    """An 8-bit PNG whose row y uses filter y % 5, written by a forward
    filter independent of the decoder under test."""
    h, w = image.shape[:2]
    bpp = 1 if image.ndim == 2 else image.shape[2]
    raw = image.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    prior = np.zeros(w * bpp, np.int64)
    for y in range(h):
        kind = y % 5
        line = raw[y]
        filt = []
        for x in range(w * bpp):
            left = line[x - bpp] if x >= bpp else 0
            up = prior[x]
            upleft = prior[x - bpp] if x >= bpp else 0
            pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][kind]
            filt.append((line[x] - pred) % 256)
        out.append(kind)
        out += bytes(filt)
        prior = line

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels, color", [(1, 0), (3, 2), (4, 6)], ids=["gray", "rgb", "rgba"])
def test_png_decode_equals_pil_for_every_filter(channels, color):
    rng = np.random.default_rng(channels)
    image = synthetic.textured_image(rng, 23, 19)
    if channels == 1:
        image = image[:, :, 0]
    elif channels == 4:
        image = np.concatenate([image, rng.integers(0, 256, (23, 19, 1), dtype=np.uint8)], -1)
    data = _filtered_png(image, color)
    got = png.decode_png(data)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data))))
    np.testing.assert_array_equal(got, image)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_load_image_rgb_equals_pil_and_jax(tmp_path, mode):
    rng = np.random.default_rng(7)
    image = synthetic.textured_image(rng, 31, 45)
    pil = Image.fromarray(image).convert(mode)
    path = str(tmp_path / f"im_{mode}.png")
    pil.save(path, optimize=True)
    got = images.load_image_rgb(path)
    assert got.shape == (31, 45, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))
    np.testing.assert_array_equal(got, jax_images.load_image_rgb(path))


def test_png_encoder_round_trip_and_unsupported_inputs(tmp_path):
    rng = np.random.default_rng(8)
    for image in (synthetic.textured_image(rng, 17, 29), rng.integers(0, 256, (5, 6), np.uint8)):
        data = png.encode_png(image)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), image)
        np.testing.assert_array_equal(png.decode_png(data), image)

    # Baseline JPEG decodes as PIL's libjpeg does (tests/test_torch_jpeg.py
    # holds it against cv2.imread); progressive JPEG still raises.
    jpeg = str(tmp_path / "a.jpg")
    Image.fromarray(synthetic.textured_image(rng, 16, 16)).save(jpeg)
    np.testing.assert_array_equal(images.load_image_rgb(jpeg), np.asarray(Image.open(jpeg)))
    Image.fromarray(synthetic.textured_image(rng, 16, 16)).save(jpeg, progressive=True)
    with pytest.raises(ValueError, match="progressive.*JPEG"):
        images.load_image_rgb(jpeg)
    bad = {}
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 60000, (4, 4)).astype(np.uint16)).save(buf, format="PNG")
    bad["16-bit"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(synthetic.textured_image(rng, 8, 8)).convert("P").save(buf, format="PNG")
    bad["palette"] = buf.getvalue()
    good = png.encode_png(rng.integers(0, 256, (4, 4, 3), np.uint8))
    bad["crc"] = good[:-5] + bytes([good[-5] ^ 1]) + good[-4:]
    bad["interlaced"] = good.replace(
        struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0), struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1))
    bad["interlaced"] = _fix_crc(bad["interlaced"])
    for name, data in bad.items():
        with pytest.raises(ValueError):
            png.decode_png(data)


def _fix_crc(data: bytes) -> bytes:
    """Recompute the IHDR CRC after an edit."""
    start = len(png.SIGNATURE)
    body = data[start + 4 : start + 8 + 13]
    return data[: start + 21] + struct.pack(">I", zlib.crc32(body)) + data[start + 25 :]


# ---------------------------------------------------------------------------
# Resizing
# ---------------------------------------------------------------------------

#: Area averages of values <= 255 in f32: a few ulps (1.5e-5 each) of
#: difference in summation order.
RESIZE_ATOL = 1e-4


@pytest.mark.parametrize("shape, out, scale", [
    ((128, 160), (102, 128), None), ((97, 131), (57, 77), None),
    ((60, 90), (30, 45), None), ((50, 70), (40, 56), 1.25),
])
def test_area_resize_matches_jax(shape, out, scale):
    image = synthetic.textured_image(np.random.default_rng(9), *shape)
    np.testing.assert_array_equal(image_ops.area_resize_matrix(shape[0], out[0], scale),
                                  jax_image_ops.area_resize_matrix(shape[0], out[0], scale))
    want = np.asarray(jax_image_ops.area_resize(jnp.asarray(image), *out, scale=scale))
    got = image_ops.area_resize(torch.from_numpy(image), *out, scale=scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == out + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL, rtol=0)


#: Sizes at which the last row's window runs past the image for each factor.
OVERRUN_SIZES = {1.0: (131, 163), 1.25: (131, 163), 1.5: (97, 131), 1.6: (131, 163),
                 2.0: (99, 131), 3.3: (131, 163)}

#: Share of uint8 values that may differ from OpenCV by one: f32 sums taken in
#: another order than OpenCV's decide a tie at .5 otherwise (measured: 2.4e-4
#: at 1.6, 0 at the other factors here).
CV2_DIFFER_SHARE = 5e-4


def _cv2_area(image, fact):
    if fact == 1.0:
        return image
    return cv2.resize(image, None, fx=1.0 / fact, fy=1.0 / fact, interpolation=cv2.INTER_AREA)


def _assert_near_cv2(got, want, share=CV2_DIFFER_SHARE):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want)
    assert diff.max(initial=0) <= 1
    assert (diff > 0).mean() <= share


@pytest.mark.parametrize("fact", [1.0, 1.25, 1.5, 1.6, 2.0, 3.3])
def test_resize_by_factor_matches_jax_route_without_cv2(tmp_path, fact):
    """Holds the downscale against the reference's ``cv2.resize(INTER_AREA)``
    (the JAX package's route where cv2 is installed), at sizes where the
    last window runs past the image, and ``load_and_downscale`` against the
    JAX package's with cv2 active."""
    h, w = OVERRUN_SIZES[fact]
    assert fact == 1.0 or round(h / fact) * fact > h
    image = synthetic.textured_image(np.random.default_rng(10), h, w)
    _assert_near_cv2(images.resize_by_factor(image, fact), _cv2_area(image, fact))

    assert jax_images._HAS_CV2
    path = str(tmp_path / "a.png")
    Image.fromarray(image).save(path)
    max_edge = int(round(w / fact))
    got_img, got_fact = images.load_and_downscale(path, max_edge, 10000)
    want_img, want_fact = jax_images.load_and_downscale(path, max_edge, 10000)
    assert got_fact == want_fact
    _assert_near_cv2(got_img, want_img)


@pytest.mark.parametrize("h, w, fact, share", [
    (1334, 2000, 1.25, 0.0), (480, 640, 1.5, 0.0), (300, 400, 2.0, 0.0),
    (97, 131, 1.7, 0.0), (4032, 6048, 3.78, 1e-4),
])
def test_resize_by_factor_equals_cv2(h, w, fact, share):
    """Exactly OpenCV's output at the match-graph cell's size (1334x2000 at
    1.25) and at 1.5, 2.0 and 1.7; at 4032x6048 / 3.78 (an ETH3D DSLR
    image under the sift caps) within one on at most 1e-4 of the values."""
    image = synthetic.textured_image(np.random.default_rng(11), h, w)
    _assert_near_cv2(images.resize_by_factor(image, fact), _cv2_area(image, fact), share)
