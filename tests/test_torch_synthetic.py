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
