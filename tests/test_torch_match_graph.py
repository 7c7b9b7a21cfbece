"""compute_match_graph and its CLI in the port against lfr_tpu's, on a
3-image PNG scene written by the port's synthetic.match_graph_workload.

Both sides must write the same pairs and matches; flow grids agree within
1e-4 displacement units in f32 (tests/test_torch_refinement.py's bound)."""

import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.config import get_method as jax_get_method
from lfr_tpu.io import protos as jax_protos
from lfr_tpu.models import checkpoint as jax_checkpoint
from lfr_tpu.pipelines import match_graph as jax_match_graph
from lfr_tpu.pipelines import refinement as jax_refinement
from lfr_tpu_torch.config import get_method
from lfr_tpu_torch.io import protos
from lfr_tpu_torch.models import checkpoint
from lfr_tpu_torch.pipelines import match_graph, refinement
from lfr_tpu_torch.utils import synthetic

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "weights" / "panet_cpu.msgpack"
ATOL = 1e-4

#: The CLI refines in bf16; against the f32 run the port's bf16 differs by
#: about the JAX package's own bf16-vs-f32 figure (~4e-3 units).
BF16_ATOL = 8e-3


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    directory = tmp_path_factory.mktemp("scene")
    truth = synthetic.match_graph_workload(np.random.default_rng(3), str(directory),
                                           num_views=3, height=128, width=160,
                                           points_per_view=24)
    return str(directory), truth


def _read_jax(path):
    with open(path, "rb") as fh:
        return jax_protos.decode_matching_file(fh.read(), use_native=False)


def _assert_files_equal(got, want, atol):
    assert [(p.image_name1, p.image_name2, p.fact1, p.fact2) for p in got] == [
        (p.image_name1, p.image_name2, p.fact1, p.fact2) for p in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.matches, w.matches)
        np.testing.assert_allclose(g.similarities, w.similarities, atol=1e-6, rtol=0)
        np.testing.assert_allclose(g.disp1, w.disp1, atol=atol, rtol=0)
        np.testing.assert_allclose(g.disp2, w.disp2, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def ours_f32(scene, tmp_path_factory):
    """The port's match graph of the scene in f32: (file, written, sub_spans)."""
    directory, truth = scene
    spans = {}
    ours = refinement.TwoViewRefiner(checkpoint.load_variables(str(WEIGHTS)), batch_size=64,
                                     compute_dtype=torch.float32, fine_mode="crop",
                                     device="cpu")
    out = str(tmp_path_factory.mktemp("ours") / "ours.pb")
    written = match_graph.compute_match_graph(
        directory, truth["match_list"], get_method("sift"), out, refiner=ours,
        sub_spans=spans, progress=False)
    return out, written, spans


def test_match_graph_matches_jax(scene, ours_f32, tmp_path):
    directory, truth = scene
    out, written, spans = ours_f32
    assert written == [out]
    theirs = jax_refinement.TwoViewRefiner(
        variables=jax_checkpoint.load_variables(str(WEIGHTS)), batch_size=64,
        compute_dtype=jnp.float32, fine_mode="crop")
    ref_out = str(tmp_path / "theirs.pb")
    jax_match_graph.compute_match_graph(directory, truth["match_list"], jax_get_method("sift"),
                                        ref_out, refiner=theirs, progress=False)
    got = protos.read_matching_file(out)
    _assert_files_equal(got, _read_jax(ref_out), ATOL)

    # Ground truth of the scene: every match joins one canvas point.
    names = [os.path.basename(n) for n in truth["images"]]
    assert len(got) == 3
    for p in got:
        a, b = names.index(p.image_name1), names.index(p.image_name2)
        m = p.matches.astype(np.int64)
        assert len(m) >= 12
        np.testing.assert_array_equal(truth["point_ids"][a][m[:, 0]],
                                      truth["point_ids"][b][m[:, 1]])
    assert spans["n_refined_matches"] == sum(p.num_matches for p in got)
    assert spans["host_decode"]["calls"] == 3


def test_skip_refinement_and_part_files_match_jax(scene, tmp_path):
    """SKIP_REFINEMENT zero grids and .part.N dumps every dump_interval pairs
    (three pairs at an interval of 2: part 0 holds two, part 1 one)."""
    directory, truth = scene
    out = str(tmp_path / "ours.pb")
    written = match_graph.compute_match_graph(
        directory, truth["match_list"], get_method("sift"), out, skip_refinement=True,
        dump_interval=2, progress=False, device="cpu")
    assert written == [f"{out}.part.0", f"{out}.part.1"]
    ref_out = str(tmp_path / "theirs.pb")
    jax_written = jax_match_graph.compute_match_graph(
        directory, truth["match_list"], jax_get_method("sift"), ref_out,
        skip_refinement=True, dump_interval=2, progress=False)
    assert [p[len(out):] for p in written] == [p[len(ref_out):] for p in jax_written]
    for ours, theirs in zip(written, jax_written):
        _assert_files_equal(protos.read_matching_file(ours), _read_jax(theirs), 0.0)
    pairs = protos.read_matching_file(out)
    assert len(pairs) == 3 and all(not p.disp1.any() and not p.disp2.any() for p in pairs)


def test_cli_refines_on_the_cpu_when_asked(scene, ours_f32, tmp_path):
    directory, truth = scene
    out = str(tmp_path / "cli.pb")
    match_graph.main([
        "--image_path", directory, "--match_list_file", truth["match_list"],
        "--method_name", "sift", "--output_file", out, "--checkpoint", str(WEIGHTS),
        "--batch_size", "64", "--device", "cpu",
    ])
    _assert_files_equal(protos.read_matching_file(out), protos.read_matching_file(ours_f32[0]),
                        BF16_ATOL)


def test_refiner_required_and_default_device(scene, tmp_path, monkeypatch):
    directory, truth = scene
    with pytest.raises(ValueError, match="TwoViewRefiner is required"):
        match_graph.compute_match_graph(directory, truth["match_list"], get_method("sift"),
                                        str(tmp_path / "a.pb"), progress=False)
    monkeypatch.delenv("SKIP_REFINEMENT", raising=False)
    with pytest.raises(SystemExit):
        match_graph.main(["--image_path", directory, "--match_list_file", truth["match_list"],
                          "--method_name", "sift", "--output_file", str(tmp_path / "b.pb")])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        match_graph.compute_match_graph(directory, truth["match_list"], get_method("sift"),
                                        str(tmp_path / "c.pb"), skip_refinement=True,
                                        progress=False)
