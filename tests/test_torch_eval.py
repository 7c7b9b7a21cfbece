"""The port's ETH3D evaluation (lfr_tpu_torch.eval.eth3d) against lfr_tpu's
on the CPU: surface sampling with a shared generator, ``.mlp`` loading with
both alignment matrices of the fixture's ``scan_alignment.mlp``, the
z-buffer visibility mask, ``evaluate_point_cloud``, ``evaluate_ply`` (first
from the sampled scan, then from the disk caches) and ``format_results``.

Tolerances: sampling, loading, the KD-tree route and the text are equal
(the same f64 numpy and scipy calls).  The visibility mask is equal: the
port forms in element-wise torch ops the f32 operations, fused
multiply-adds included, that XLA compiles for the JAX package on the CPU.
On the brute-force route fractions may differ only by queries within 2 ulp
of a tol^2 (tests/test_torch_nn_dist.py).  Each package evaluates its own
copy of the dataset, so that neither reads the other's disk cache.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from lfr_tpu.eval import eth3d as jax_eth3d
from lfr_tpu.io import colmap_model as jax_model
from lfr_tpu_torch.eval import eth3d
from lfr_tpu_torch.io import colmap_model
from lfr_tpu_torch.ops import nn_dist
from lfr_tpu_torch.utils import synthetic

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "eth3d_mini", "relief_mini")
MLP = os.path.join("dslr_scan_eval", "scan_alignment.mlp")
CALIBRATION = "dslr_calibration_undistorted"
#: Surface spacing of the evaluate_ply test: twice the default, so a
#: quarter of the fixture scan's 4.3 million samples.
SPACING = 0.005


@pytest.fixture
def copies(tmp_path):
    roots = {}
    for pkg in ("jax", "port"):
        roots[pkg] = str(tmp_path / pkg / "relief_mini")
        shutil.copytree(FIXTURE, roots[pkg])
    yield roots
    for module in (eth3d, jax_eth3d):
        module._scan_cache.clear()
        module._visible_scan_cache.clear()


@pytest.mark.parametrize("max_samples", [eth3d.MAX_SURFACE_SAMPLES, 5000])
def test_surface_sampling_matches_jax(max_samples):
    xyz, faces = synthetic.layered_surface_mesh(bg_half=0.4, slabs=((6.5, -0.2, 0.1, -0.1, 0.2),))
    got = eth3d.sample_mesh_surface(xyz, faces, 0.01, np.random.default_rng(4), max_samples)
    want = jax_eth3d.sample_mesh_surface(xyz, faces, 0.01, np.random.default_rng(4), max_samples)
    assert got.dtype == np.float64 and got.shape[0] > 1000
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] <= max_samples + faces.shape[0]


def test_mlp_scan_applies_both_alignments_as_jax():
    path = os.path.join(FIXTURE, MLP)
    got, mode = eth3d.load_mlp_scan(path, surface_spacing=0)
    want, want_mode = jax_eth3d.load_mlp_scan(path, surface_spacing=0)
    assert mode == want_mode == "vertex"
    np.testing.assert_array_equal(got, want)
    # Vertices of each mesh moved by its own matrix.
    scan_dir = os.path.dirname(path)
    raw = [colmap_model.read_ply_mesh(os.path.join(scan_dir, f"scan{i}.ply"))[0] for i in (1, 2)]
    assert got.shape[0] == sum(r.shape[0] for r in raw)
    assert np.abs(got[: raw[0].shape[0]] - raw[0]).max() > 0.1
    surface, mode = eth3d.load_mlp_scan(path, surface_spacing=0.01)
    np.testing.assert_array_equal(surface, jax_eth3d.load_mlp_scan(path, 0.01)[0])
    assert mode == "surface"


def _layered_dataset(root):
    rng = np.random.default_rng(1)
    scene, images = synthetic.layered_scene(rng, num_points=40, num_cameras=4, width=200,
                                            height=150)
    mesh = synthetic.layered_surface_mesh(bg_half=0.5)
    synthetic.make_eth3d_dataset(root, scene, rng, rendered_images=images, scan_mesh=mesh)
    return eth3d.sample_mesh_surface(*mesh, spacing=0.01)


@pytest.mark.parametrize("scene", ["layered", "fixture"])
def test_visibility_mask_equals_jax(tmp_path, scene):
    if scene == "layered":
        root = str(tmp_path / "layered")
        scan = _layered_dataset(root)
    else:
        root = FIXTURE
        scan = eth3d.load_mlp_scan(os.path.join(root, MLP), surface_spacing=0.005)[0]
    model_dir = os.path.join(root, CALIBRATION)
    got = eth3d.scan_visibility_mask(scan, colmap_model.read_model(model_dir), device="cpu")
    want = jax_eth3d.scan_visibility_mask(scan, jax_model.read_model(model_dir))
    assert got.dtype == bool and got.shape == (scan.shape[0],)
    assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)


def _reconstruction(root, n=300, seed=2):
    """A PLY of scan points plus 1-3 cm of noise, and a few outliers."""
    scan, _ = jax_eth3d.load_mlp_scan(os.path.join(FIXTURE, MLP), surface_spacing=0.02)
    rng = np.random.default_rng(seed)
    xyz = scan[rng.choice(scan.shape[0], n, replace=False)]
    xyz = xyz + rng.normal(0, 0.015, xyz.shape)
    xyz[: n // 10] += rng.uniform(-1, 1, (n // 10, 3))
    points = {
        i + 1: colmap_model.Point3D(i + 1, xyz[i], np.full(3, 128, np.uint8), 0.0,
                                    np.zeros(0, np.int64), np.zeros(0, np.int64))
        for i in range(n)
    }
    path = os.path.join(root, "rec.ply")
    colmap_model.write_ply(path, points)
    return path


def test_evaluate_ply_and_format_equal_jax(copies):
    results = {}
    for pkg, module in (("jax", jax_eth3d), ("port", eth3d)):
        root = copies[pkg]
        ply = _reconstruction(root)
        kwargs = {"device": "cpu"} if pkg == "port" else {}
        first = module.evaluate_ply(ply, os.path.join(root, MLP), surface_spacing=SPACING,
                                    gt_model_path=os.path.join(root, CALIBRATION), **kwargs)
        # Again from the disk caches (f32 samples and the visible set).
        module._scan_cache.clear()
        module._visible_scan_cache.clear()
        second = module.evaluate_ply(ply, os.path.join(root, MLP), surface_spacing=SPACING,
                                     gt_model_path=os.path.join(root, CALIBRATION), **kwargs)
        assert os.path.exists(os.path.join(root, MLP) + f".samples-{SPACING}.npz")
        results[pkg] = (first, second, module.format_results(first))
    assert results["port"] == results["jax"]
    first = results["port"][0]
    assert first["evaluation_mode"] == "surface+visibility"
    assert 0 < first["accuracies"][0] < first["accuracies"][-1] <= 1.0


def test_evaluate_point_cloud_brute_force_and_edge_cases(monkeypatch):
    scan, _ = jax_eth3d.load_mlp_scan(os.path.join(FIXTURE, MLP), surface_spacing=0.05)
    rng = np.random.default_rng(3)
    rec = scan[rng.choice(scan.shape[0], 200, replace=False)] + rng.normal(0, 0.02, (200, 3))
    visible = scan[::3]
    tree = eth3d.evaluate_point_cloud(rec, scan, mode="surface", scan_completeness=visible,
                                      device="cpu")
    assert tree == jax_eth3d.evaluate_point_cloud(rec, scan, mode="surface",
                                                  scan_completeness=visible)
    # The brute-force routes: the JAX package's forced by its environment
    # switch, the port's (its plain version on the CPU) by patching its rule.
    monkeypatch.setenv("LFR_EVAL_BRUTE", "1")
    monkeypatch.setattr(eth3d, "_use_brute", lambda nq, nc, device: True)
    got = eth3d.evaluate_point_cloud(rec, scan, mode="surface", scan_completeness=visible,
                                     device="cpu")
    want = jax_eth3d.evaluate_point_cloud(rec, scan, mode="surface", scan_completeness=visible)
    tol2 = np.square(np.asarray(eth3d.ETH3D_TOLERANCES, np.float32))
    for key, queries, corpus in (("accuracies", rec, scan), ("completenesses", visible, rec)):
        d2 = nn_dist.nn_min_sq(torch.from_numpy(queries.astype(np.float32)),
                               torch.from_numpy(corpus.astype(np.float32))).numpy()
        for g, w, t2 in zip(got[key], want[key], tol2):
            near = (np.abs(d2.astype(np.float64) - t2) <= 2 * np.spacing(t2)).sum()
            assert abs(g - w) * queries.shape[0] <= near + 1e-9
    monkeypatch.undo()
    empty = eth3d.evaluate_point_cloud(np.zeros((0, 3)), scan, device="cpu")
    assert empty == jax_eth3d.evaluate_point_cloud(np.zeros((0, 3)), scan)
    with pytest.warns(RuntimeWarning, match="visibility mask"):
        masked = eth3d.evaluate_point_cloud(rec, scan, scan_completeness=np.zeros((0, 3)),
                                            device="cpu")
    assert masked["completenesses"] == [0.0] * 6 and masked["accuracies"] == tree["accuracies"]
