"""The port's ``benchmark eth`` driver (lfr_tpu_torch.pipelines.benchmark)
against lfr_tpu's ``run_eth`` on the CPU.

- Real images: copies of the ``eth3d_mini/relief_mini`` fixture (JPEG,
  nested image directory, a two-mesh ``.mlp`` scan), bootstrapped by each
  package's dataset tools, with ``.sift`` files written by lfr_tpu's
  extractor into both (the port has no extractor yet), run with
  ``skip_refinement``.  Registered images must be equal and point counts
  within POINT_COUNT_RTOL: the two packages verify with different RANSAC
  samplers (ROADMAP Queue 3), and on this scene they differ by 1 point of
  51.  Each package's ``evaluate_ply`` of the other's PLY must equal the
  other's own evaluation.
- Refinement: a 3-camera ``layered_scene`` dataset with PANet weights
  ``weights/panet_cpu.msgpack``, ref and raw.  The refinement runs in bf16
  in both packages, which round at other places, so the refined models may
  differ slightly: registered images equal, point counts within
  POINT_COUNT_RTOL, ref's mean reprojection error within REPROJ_RTOL, each
  accuracy and completeness within FRACTION_POINTS points of the
  reconstruction's (or the scan's) count, and the cross-evaluations equal.
- The CLI's help.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from lfr_tpu.eval import eth3d as jax_eth3d
from lfr_tpu.pipelines import benchmark as jax_benchmark
from lfr_tpu.pipelines import dataset_tools as jax_tools
from lfr_tpu.pipelines import extract_features
from lfr_tpu_torch.eval import eth3d
from lfr_tpu_torch.pipelines import benchmark, dataset_tools
from lfr_tpu_torch.utils import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "eth3d_mini", "relief_mini")
WEIGHTS = os.path.join(ROOT, "weights", "panet_cpu.msgpack")

POINT_COUNT_RTOL = 0.03
REPROJ_RTOL = 0.05
FRACTION_POINTS = 2


@pytest.fixture(autouse=True)
def _clean_caches():
    yield
    for module in (eth3d, jax_eth3d):
        module._scan_cache.clear()
        module._visible_scan_cache.clear()


def _evaluate_other(results, roots, tag):
    """Each package's evaluate_ply of the other package's PLY."""
    out = {}
    for pkg, other, module in (("port", "jax", eth3d), ("jax", "port", jax_eth3d)):
        root = roots[pkg]
        kwargs = {"device": "cpu"} if pkg == "port" else {}
        out[pkg] = module.evaluate_ply(
            os.path.join(roots[other], f"sparse-sift-{tag}.ply"),
            os.path.join(root, "dslr_scan_eval", "scan_alignment.mlp"),
            gt_model_path=os.path.join(root, "dslr_calibration_undistorted"),
            **kwargs,
        )
    assert out["port"] == results["jax"][tag]["evaluation"]
    assert out["jax"] == results["port"][tag]["evaluation"]


def _close_counts(got, want):
    assert abs(got - want) <= POINT_COUNT_RTOL * want, (got, want)


def test_real_images_skip_refinement_match_jax(tmp_path):
    roots = {pkg: str(tmp_path / pkg / "relief_mini") for pkg in ("jax", "port")}
    for pkg, tools in (("jax", jax_tools), ("port", dataset_tools)):
        shutil.copytree(FIXTURE, roots[pkg])
        tools.main(["create-db-eth", "--dataset_path", roots[pkg]])
        tools.main(["match-list", "--dataset_path", roots[pkg]])
    image_dir = os.path.join("images", "dslr_images_undistorted")
    assert extract_features.extract_directory(
        os.path.join(roots["jax"], "images"), "sift", max_features=1500, verbose=False) == 3
    for name in os.listdir(os.path.join(roots["jax"], image_dir)):
        if name.endswith(".sift"):
            shutil.copy(os.path.join(roots["jax"], image_dir, name),
                        os.path.join(roots["port"], image_dir, name))
    results = {
        "jax": jax_benchmark.run_eth(roots["jax"], "sift", output_path=str(tmp_path / "jax_out"),
                                     skip_refinement=True, verbose=False),
        "port": benchmark.run_eth(roots["port"], "sift", output_path=str(tmp_path / "port_out"),
                                  skip_refinement=True, verbose=False, device="cpu"),
    }
    got, want = (results[p]["raw"]["triangulation"] for p in ("port", "jax"))
    assert got["num_reg_images"] == want["num_reg_images"] == 3
    _close_counts(got["num_sparse_points"], want["num_sparse_points"])
    assert got["num_sparse_points"] > 40
    _evaluate_other(results, roots, "raw")
    ev = results["port"]["raw"]["evaluation"]
    assert ev["evaluation_mode"] == "surface+visibility" and ev["accuracies"][3] > 0.5
    spans = [s["span"] for s in results["port"]["timing"]]
    assert spans == ["match_graph", "triangulation_raw", "evaluation_raw/scan",
                     "evaluation_raw/visibility", "evaluation_raw/nn", "evaluation_raw"]
    with open(tmp_path / "port_out" / "sift-relief_mini-raw.txt") as fh:
        assert fh.read() == eth3d.format_results(ev)


def test_refinement_run_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("LFR_NO_SCAN_CACHE", "1")
    rng = np.random.default_rng(0)
    base = str(tmp_path / "base" / "scene")
    scene, images = synthetic.layered_scene(rng, num_points=96, num_cameras=3, width=320,
                                            height=240, exposure_jitter=0.1)
    # A small scan (the background and slabs cut to 0.8 m) keeps the
    # evaluation's surface samples few on the CPU.
    mesh = synthetic.layered_surface_mesh(
        bg_half=0.4, slabs=((5.2, -0.4, 0.0, -0.3, 0.3), (6.0, 0.0, 0.4, -0.3, 0.3)))
    synthetic.make_eth3d_dataset(base, scene, rng, keypoint_noise_px=1.0,
                                 rendered_images=images, scan_mesh=mesh)
    roots = {}
    for pkg in ("jax", "port"):
        roots[pkg] = str(tmp_path / pkg / "scene")
        shutil.copytree(base, roots[pkg])
    results = {
        "jax": jax_benchmark.run_eth(roots["jax"], "sift", output_path=str(tmp_path / "jax_out"),
                                     checkpoint=WEIGHTS, verbose=False),
        "port": benchmark.run_eth(roots["port"], "sift", output_path=str(tmp_path / "port_out"),
                                  checkpoint=WEIGHTS, verbose=False, device="cpu"),
    }
    for tag in ("ref", "raw"):
        got, want = (results[p][tag]["triangulation"] for p in ("port", "jax"))
        assert got["num_reg_images"] == want["num_reg_images"] == 3
        _close_counts(got["num_sparse_points"], want["num_sparse_points"])
        n_rec = got["num_sparse_points"]
        for key in ("accuracies", "completenesses"):
            g, w = (np.asarray(results[p][tag]["evaluation"][key]) for p in ("port", "jax"))
            count = n_rec if key == "accuracies" else None
            if count:
                assert np.abs(g - w).max() * count <= FRACTION_POINTS, (tag, key, g, w)
            else:
                assert np.abs(g - w).max() <= 0.01, (tag, key, g, w)
        _evaluate_other(results, roots, tag)
    ref, raw = (results["port"][t]["triangulation"] for t in ("ref", "raw"))
    want_ref = results["jax"]["ref"]["triangulation"]
    assert abs(ref["mean_reproj_error"] - want_ref["mean_reproj_error"]) <= (
        REPROJ_RTOL * want_ref["mean_reproj_error"])
    assert ref["mean_reproj_error"] < 0.5 * raw["mean_reproj_error"]
    acc = {t: results["port"][t]["evaluation"]["accuracies"][0] for t in ("ref", "raw")}
    assert acc["ref"] > acc["raw"]
    spans = [s["span"] for s in results["port"]["timing"]]
    assert spans[:3] == ["match_graph", "solve", "triangulation_ref"]


def test_run_eth_without_weights_raises(tmp_path):
    with pytest.raises(ValueError, match="PANet weights"):
        benchmark.run_eth(str(tmp_path), "sift", output_path=str(tmp_path / "out"), device="cpu")


def test_cli_help_lists_the_eth_driver():
    env = dict(os.environ, PYTHONPATH=ROOT)
    top = subprocess.run([sys.executable, "-m", "lfr_tpu_torch"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert top.returncode == 0
    for command in ("match", "solve", "triangulate", "benchmark", "dataset", "compare"):
        assert f"  {command} " in top.stdout
    eth = subprocess.run([sys.executable, "-m", "lfr_tpu_torch", "benchmark", "eth", "--help"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert eth.returncode == 0
    for flag in ("--dataset_path", "--method_name", "--checkpoint", "--no_eval", "--device"):
        assert flag in eth.stdout
