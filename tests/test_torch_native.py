"""The port's host C++ library (csrc/lfr_native.cc) against its numpy routes
and the JAX package's.

Every comparison is bit for bit: encoded bytes, decoded arrays and names,
match orders, argsorts and the ``Tracks`` of ``build_tracks``.  The JAX
side runs with ``use_native=False``; its C++ decoder gives an empty
``image_name1`` the value of ``image_name2`` (ROADMAP Queue 3), which the
port's does not copy.  The forest's ``parent`` array may differ between
path-compression orders while the tracks agree, so tracks are compared.
"""

import numpy as np
import pytest

from lfr_tpu.io import protos as jax_protos
from lfr_tpu.solver import graph as jax_graph
from lfr_tpu.solver import tracks as jax_tracks
from lfr_tpu_torch.io import protos
from lfr_tpu_torch.ops import host_build
from lfr_tpu_torch.solver import graph, native, tracks
from lfr_tpu_torch.utils import synthetic

PAIR_FIELDS = ("matches", "similarities", "disp1", "disp2")


def _pairs(seed=0, n_images=5, n_points=40):
    """A noisy match graph with the wire format's edge cases: a pair
    without image_name1, one without image_name2, a pair with no matches, a
    zero fact, zero indices, similarities and grid entries, and a large
    feature index (multi-byte varints)."""
    pairs = synthetic.solver_graph(np.random.default_rng(seed), n_images, n_points, 0.7, 0.1)
    rng = np.random.default_rng(seed + 1)
    for p in pairs:
        p.disp1 = (p.disp1 + rng.normal(0, 0.2, p.disp1.shape)).astype(np.float32)
        p.disp2 = (p.disp2 + rng.normal(0, 0.2, p.disp2.shape)).astype(np.float32)
        p.disp1[0, 1, 1, 0] = 0.0
        p.disp2[-1] = 0.0
        p.similarities[0] = 0.0
    pairs[0].image_name1 = ""
    pairs[1].image_name2 = ""
    pairs[1].fact1 = 0.0
    pairs[2].matches[0] = (0, 2**31 + 7)
    z = np.zeros((0, 3, 3, 2), np.float32)
    pairs.append(protos.PairMatches("empty_a", 0.5, "empty_b", 2.0,
                                    np.zeros((0, 2), np.uint32), np.zeros(0, np.float32), z, z))
    return pairs


def _to_jax(pairs):
    return [jax_protos.PairMatches(p.image_name1, p.fact1, p.image_name2, p.fact2,
                                   p.matches, p.similarities, p.disp1, p.disp2)
            for p in pairs]


def _assert_pairs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.image_name1, a.image_name2) == (b.image_name1, b.image_name2)
        assert (a.fact1, a.fact2) == (b.fact1, b.fact2)
        for field in PAIR_FIELDS:
            x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
            assert x.dtype == y.dtype and x.shape == y.shape, field
            assert x.tobytes() == y.tobytes(), field


def test_encoder_bytes_equal_numpy_and_jax():
    pairs = _pairs()
    want = protos.encode_matching_file(pairs, use_native=False)
    assert protos.encode_matching_file(pairs) == want
    assert jax_protos.encode_matching_file(_to_jax(pairs), use_native=False) == want
    assert protos.encode_matching_file([]) == b""


def test_decoder_equals_numpy_and_jax_and_keeps_an_empty_name1():
    pairs = _pairs()
    blob = protos.encode_matching_file(pairs, use_native=False)
    got = protos.decode_matching_file(blob)
    _assert_pairs_equal(got, protos.decode_matching_file(blob, use_native=False))
    _assert_pairs_equal(got, jax_protos.decode_matching_file(blob, use_native=False))
    _assert_pairs_equal(got, pairs)
    assert got[0].image_name1 == "" and got[0].image_name2 == pairs[0].image_name2
    assert got[1].image_name2 == "" and got[1].fact1 == 0.0
    assert protos.decode_matching_file(b"") == []


def test_decoder_reads_a_multi_part_file_and_rejects_truncation(tmp_path):
    pairs = _pairs(seed=3)
    path = str(tmp_path / "matches.pb")
    for k, part in enumerate((pairs[:4], pairs[4:])):
        protos.write_matching_file(f"{path}.part.{k}", part)
    assert (tmp_path / "matches.pb.part.0").read_bytes() == protos.encode_matching_file(
        pairs[:4], use_native=False)
    got = protos.read_matching_file(path)
    plain = [p for k in range(2) for p in protos.decode_matching_file(
        (tmp_path / f"matches.pb.part.{k}").read_bytes(), use_native=False)]
    _assert_pairs_equal(got, plain)
    _assert_pairs_equal(got, pairs)
    blob = protos.encode_matching_file(pairs)
    with pytest.raises(ValueError, match="malformed"):
        protos.decode_matching_file(blob[: len(blob) - 3])


@pytest.mark.parametrize("n, n_threads", [(1000, 4), (70_000, 4), (70_000, 1), (70_001, 3)])
def test_sort_matches_desc_equals_lexsort_with_ties(n, n_threads):
    rng = np.random.default_rng(n + n_threads)
    sim = rng.choice(np.array([0.25, 0.5, 0.75, 1.0], np.float32), n)
    src = rng.integers(0, 50, n)
    dst = rng.integers(0, 50, n)
    want = np.lexsort((dst, src, sim))[::-1]
    np.testing.assert_array_equal(native.sort_matches_desc(sim, src, dst, n_threads), want)


def test_counting_argsort_equals_stable_argsort():
    rng = np.random.default_rng(5)
    for n, n_vals in ((0, 3), (17, 1), (10_000, 7), (100_000, 5_000)):
        vals = rng.integers(0, n_vals, n)
        np.testing.assert_array_equal(native.counting_argsort(vals, n_vals),
                                      np.argsort(vals, kind="stable"))
    with pytest.raises(ValueError, match="keys"):
        native.counting_argsort(np.array([0, 3]), 3)
    with pytest.raises(ValueError, match="src"):
        native.msf_union_find(np.array([0]), np.array([5]), np.array([0]), np.zeros(5), 5)
    with pytest.raises(ValueError, match="order"):
        native.msf_union_find(np.array([1]), np.array([0]), np.array([1]), np.zeros(5), 5)


@pytest.mark.parametrize("seed, n_images, n_points", [(0, 6, 60), (2, 10, 200)])
def test_build_tracks_routes_equal_jax(seed, n_images, n_points):
    pairs = _pairs(seed, n_images, n_points)
    g = graph.build_graph(pairs)
    got = tracks.build_tracks(g)
    plain = tracks.build_tracks(g, use_native=False)
    want = jax_tracks.build_tracks(jax_graph.build_graph(_to_jax(pairs)), use_native=False)
    for other in (plain, want):
        assert (got.num_tracks, got.max_track_size) == (other.num_tracks, other.max_track_size)
        np.testing.assert_array_equal(got.track_idx, other.track_idx)
        np.testing.assert_array_equal(got.is_root, other.is_root)
    assert got.max_track_size > 2



def test_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    bad = tmp_path / "lfr_native.cc"
    bad.write_text("extern \"C\" int lfr_broken( { }\n")
    monkeypatch.setattr(host_build, "SOURCE", str(bad))
    monkeypatch.setattr(host_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(host_build, "_LOADED", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        protos.decode_matching_file(b"")
    assert "lfr_broken" in str(info.value)
    assert not (tmp_path / "build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_decoder_rejects_a_match_longer_than_its_pair():
    """A Match whose length runs past its pair's end fails the decode
    instead of reading past the buffer."""
    body = bytes([0x2A, 0x05, 0x08, 0x01])  # a Match of 5 bytes with 2 left
    for blob in (bytes([0x0A, len(body)]) + body,
                 bytes([0x0A, 6, 0x2A, 0x04, 0x22, 0x09, 0x0D, 0x00])):  # a grid entry too
        with pytest.raises(ValueError, match="malformed"):
            protos.decode_matching_file(blob)
