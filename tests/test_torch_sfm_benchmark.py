"""The port's SfM entry points (``run_sfm``, ``benchmark lfe`` / ``custom`` and
``reconstruct``) against lfr_tpu's ``run_sfm`` on the CPU, on
tests/test_pipeline_e2e.py:56's 4-camera scene with ``skip_refinement``.

The two packages verify and register with different RANSAC samplers
(ROADMAP Queue 3), so the comparison is of what must not depend on them:
the two-line JSON's keys (the port's matching line adds
``num_putative_pairs`` and ``verify_batches``), the registered images, and
point counts within POINT_COUNT_RTOL (the scene has 120 points).  A
caller's MatchingFile given without a SolutionFile is read, solved, and
never written (the JAX package writes the match graph over it).
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from lfr_tpu.pipelines import benchmark as jax_benchmark
from lfr_tpu.utils import synthetic as jax_synthetic
from lfr_tpu_torch import __main__ as cli
from lfr_tpu_torch.pipelines import benchmark

POINT_COUNT_RTOL = 0.03

#: Keys the port's matching statistics add to the JAX package's.
PORT_MATCHING_KEYS = {"num_putative_pairs", "verify_batches"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of tiny torch ops,
    which the suite's parallel workers slow down by oversubscribing the
    cores; the thread count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    """The pristine dataset (JAX's generator, as tests/test_pipeline_e2e.py
    writes it)."""
    root = str(tmp_path_factory.mktemp("sfm") / "sfm_scene")
    rng = np.random.default_rng(7)
    scene = jax_synthetic.random_scene(rng, num_points=120, num_cameras=4, noise_px=0.2)
    jax_synthetic.make_eth3d_dataset(root, scene, rng, keypoint_noise_px=0.2)
    return root


def _copy(root, tmp_path, name):
    dst = str(tmp_path / name / os.path.basename(root))
    shutil.copytree(root, dst)
    return dst


def _json_lines(out, root, tag):
    with open(os.path.join(out, f"sift-{os.path.basename(root)}-{tag}.json")) as fh:
        return [json.loads(line) for line in fh.read().strip().split("\n")]


@pytest.fixture(scope="module")
def jax_result(scene_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    root = _copy(scene_root, tmp, "data")
    out = str(tmp / "out")
    results = jax_benchmark.run_sfm(root, "sift", output_path=out, skip_refinement=True,
                                    verbose=False)
    return results, _json_lines(out, root, "raw")


def _check_against_jax(port_lines, jax_result):
    results, jax_lines = jax_result
    assert len(port_lines) == 2
    assert set(port_lines[0]) == set(jax_lines[0]) | PORT_MATCHING_KEYS
    assert set(port_lines[1]) == set(jax_lines[1])
    rec, jax_rec = port_lines[1], results["raw"]["reconstruction"]
    assert rec["num_reg_images"] == jax_rec["num_reg_images"] == 4
    assert abs(rec["num_sparse_points"] - jax_rec["num_sparse_points"]) <= (
        POINT_COUNT_RTOL * jax_rec["num_sparse_points"])
    assert rec["mean_reproj_error"] < 0.5  # as tests/test_pipeline_e2e.py


def test_run_sfm_skip_refinement_matches_jax(scene_root, jax_result, tmp_path):
    root = _copy(scene_root, tmp_path, "data")
    out = str(tmp_path / "out")
    results = benchmark.run_sfm(root, "sift", output_path=out, skip_refinement=True,
                                verbose=False, device="cpu")
    _check_against_jax(_json_lines(out, root, "raw"), jax_result)
    assert [s["span"] for s in results["timing"]] == ["match_graph", "reconstruction_raw"]
    assert os.path.exists(os.path.join(root, "sparse-sift-raw", "points3D.txt"))
    assert os.path.exists(os.path.join(root, "sparse-sift-raw.ply"))
    with pytest.raises(FileExistsError):  # the database of a run is never reused
        benchmark.run_sfm(root, "sift", output_path=out, skip_refinement=True, verbose=False,
                          device="cpu")


def test_cli_custom_then_reconstruct(scene_root, jax_result, tmp_path, monkeypatch):
    """``python -m lfr_tpu_torch benchmark custom`` and ``reconstruct`` with
    ``--device cpu``; reconstruct reads the match graph that custom wrote."""
    root = _copy(scene_root, tmp_path, "a")
    out = str(tmp_path / "out")
    monkeypatch.setenv("SKIP_REFINEMENT", "1")
    assert cli.main(["benchmark", "custom", "--dataset_path", root, "--method_name", "sift",
                     "--output_path", out, "--device", "cpu"]) == 0
    _check_against_jax(_json_lines(out, root, "raw"), jax_result)

    root_b = _copy(scene_root, tmp_path, "b")
    matches = os.path.join(out, f"sift-{os.path.basename(root)}-matches.pb")
    out_json = str(tmp_path / "reconstruct.json")
    assert cli.main(["reconstruct", "--dataset_path", root_b, "--method_name", "sift",
                     "--matches_file", matches, "--output_file", out_json,
                     "--device", "cpu"]) == 0
    with open(out_json) as fh:
        lines = [json.loads(line) for line in fh.read().strip().split("\n")]
    _check_against_jax(lines, jax_result)
    assert "reconstruct" in cli._usage() and "lfe" in benchmark.__doc__


def test_given_matches_file_is_read_not_written(scene_root, tmp_path):
    """A MatchingFile passed without a SolutionFile, refinement on: the
    solve runs on it and writes its SolutionFile under output_path, ref and
    raw reconstruct, and the caller's file keeps its bytes."""
    root = _copy(scene_root, tmp_path, "first")
    out = str(tmp_path / "out_first")
    benchmark.run_sfm(root, "sift", output_path=out, skip_refinement=True, verbose=False,
                      device="cpu")
    mine = str(tmp_path / "mine.pb")
    shutil.copy(os.path.join(out, f"sift-{os.path.basename(root)}-matches.pb"), mine)
    with open(mine, "rb") as fh:
        before = hashlib.sha256(fh.read()).hexdigest()

    root2 = _copy(scene_root, tmp_path, "second")
    out2 = str(tmp_path / "out_second")
    results = benchmark.run_sfm(root2, "sift", output_path=out2, matches_file=mine,
                                verbose=False, device="cpu")
    with open(mine, "rb") as fh:
        assert hashlib.sha256(fh.read()).hexdigest() == before
    assert [s["span"] for s in results["timing"]] == ["solve", "reconstruction_ref",
                                                      "reconstruction_raw"]
    assert os.path.exists(os.path.join(out2, f"sift-{os.path.basename(root2)}-solution.pb"))
    assert not os.path.exists(os.path.join(out2, f"sift-{os.path.basename(root2)}-matches.pb"))
    for tag in ("ref", "raw"):
        assert results[tag]["reconstruction"]["num_reg_images"] == 4
