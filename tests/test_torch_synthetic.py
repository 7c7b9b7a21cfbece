"""The port's numpy copy of the synthetic data against lfr_tpu's: the same
seed must give the same arrays, bit for bit."""

import numpy as np
import pytest

from lfr_tpu.utils import synthetic as jax_synthetic
from lfr_tpu_torch.utils import synthetic


@pytest.mark.parametrize(
    "name, args",
    [
        ("textured_image", (50, 70)),
        ("shifted_pair", (40, 56, (2, -3))),
        ("planted_features", (17, 60, 80)),
    ],
)
def test_generators_match_jax_package(name, args):
    got = getattr(synthetic, name)(np.random.default_rng(5), *args)
    want = getattr(jax_synthetic, name)(np.random.default_rng(5), *args)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_bench_workload_is_bench_py_workload():
    """bench.py builds its 2048-match workload from lfr_tpu.utils.synthetic."""
    image1, image2, kps1, kps2, matches = synthetic.bench_workload(np.random.default_rng(0))
    rng = np.random.default_rng(0)
    want1, want2 = jax_synthetic.shifted_pair(rng, 480, 640, (3, -2))
    want_kps1, _ = jax_synthetic.planted_features(rng, 2048, 480, 640)
    np.testing.assert_array_equal(image1, want1)
    np.testing.assert_array_equal(image2, want2)
    np.testing.assert_array_equal(kps1, want_kps1)
    np.testing.assert_array_equal(kps2, want_kps1 + np.array([2.0, -3.0]))
    np.testing.assert_array_equal(matches, np.stack([np.arange(2048)] * 2, axis=1))


def test_match_graph_workload_writes_a_consistent_scene(tmp_path):
    from lfr_tpu_torch.io import features, match_list, png

    truth = synthetic.match_graph_workload(np.random.default_rng(4), str(tmp_path), num_views=3,
                                           height=100, width=120, points_per_view=9)
    names = truth["images"]
    assert match_list.read_match_list(truth["match_list"]) == match_list.exhaustive_pairs(names)
    assert (truth["offsets"] % 5 == 0).all()
    views, canvas_xy = [], {}
    for name, ids, (oy, ox) in zip(names, truth["point_ids"], truth["offsets"]):
        with open(tmp_path / name, "rb") as fh:
            image = png.decode_png(fh.read())
        assert image.shape == (100, 120, 3) and image.dtype == np.uint8
        views.append((image, oy, ox))
        feats = features.load_features(str(tmp_path / name), "sift")
        assert feats.keypoints.shape == (9, 2) and len(set(ids)) == 9
        np.testing.assert_allclose(np.linalg.norm(feats.descriptors, axis=1), 1.0, atol=1e-6)
        for pid, xy in zip(ids, feats.keypoints + [ox, oy]):
            # Every view sees a canvas point at one canvas position.
            np.testing.assert_allclose(canvas_xy.setdefault(pid, xy), xy, atol=1e-9)
    with pytest.raises(ValueError, match="share no area"):
        synthetic.match_graph_workload(np.random.default_rng(4), str(tmp_path), height=40,
                                       width=56)
    # The views are crops of one canvas: equal where they overlap.
    (a, ay, ax), (b, by, bx) = views[0], views[1]
    y0, x0 = max(ay, by), max(ax, bx)
    y1, x1 = min(ay, by) + 100, min(ax, bx) + 120
    np.testing.assert_array_equal(a[y0 - ay : y1 - ay, x0 - ax : x1 - ax],
                                  b[y0 - by : y1 - by, x0 - bx : x1 - bx])
