"""The port's dry runs and utilities: the multi-process launcher against
its own single process (as tests/test_multiprocess.py runs the JAX
package's), the health probe, the build meter, ``entry`` and
bench_torch.py's FLOP count.

The launcher's parity bound is the JAX dry run's (1e-3 on the solved camera
translations and the first component's positions); the two runs split the
BA's points differently, so their sums round differently.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

from lfr_tpu_torch import dryrun
from lfr_tpu_torch.models import panet
from lfr_tpu_torch.ops import host_build
from lfr_tpu_torch.parallel import multiprocess
from lfr_tpu_torch.utils import healthprobe
from lfr_tpu_torch.utils.timing import BuildMeter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: tests/test_multiprocess.py:36's small sizes (BA at its defaults).
SMALL = dict(global_batch=16, iterations=5, ba_cams=6, ba_pts=60, ba_iters=8)


def test_two_processes_match_one(monkeypatch):
    monkeypatch.setattr(dryrun, "MULTIPROCESS_SIZES", SMALL)
    report = dryrun.dryrun_multiprocess(2, device="cpu")
    assert report["n_processes"] == 2 and report["backend"] == "gloo"
    assert report["parity_max_abs"] < dryrun.PARITY_ATOL
    assert report["ba_rms_px"] > 0 and report["ba_obs"] == SMALL["ba_cams"] * SMALL["ba_pts"]
    for key in ("single_proc_solve_ms", "multi_proc_solve_ms", "single_ba_ms", "multi_ba_ms",
                "process_boundary_efficiency", "ba_efficiency"):
        assert report[key] > 0, key


def _fake_python(tmp_path, body):
    path = tmp_path / "python"
    path.write_text(f"#!/bin/sh\n{body}\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_launch_raises_on_a_failed_or_hung_worker(tmp_path, monkeypatch):
    monkeypatch.setattr(multiprocess.sys, "executable", _fake_python(tmp_path, "exit 3"))
    with pytest.raises(RuntimeError, match="rc=3"):
        multiprocess.launch(2, device="cpu", timeout=30)
    monkeypatch.setattr(multiprocess.sys, "executable", _fake_python(tmp_path, "sleep 30"))
    with pytest.raises(RuntimeError, match="timed out"):
        multiprocess.launch(2, device="cpu", timeout=1)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        multiprocess.launch(2)


def test_demo_problems_equal_jax():
    from lfr_tpu.parallel import multiprocess as jax_mp

    got, want = multiprocess.demo_component_batch(16, n=12, e=30), \
        jax_mp._demo_component_batch(16, n=12, e=30)
    for field in ("edge_src", "edge_dst", "edge_sim", "edge_flow", "edge_intra", "edge_valid",
                  "is_root", "node_valid"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    got, want = multiprocess.demo_ba_problem(5, 30), jax_mp._demo_ba_problem(5, 30)
    for field in ("R", "t", "points", "obs_cam", "obs_pt", "obs_uv", "obs_focal",
                  "fixed_cameras"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert multiprocess.local_rows(10, rank=1, world=2) == (5, 10)
    assert multiprocess.local_rows(10) == (0, 10)
    with pytest.raises(ValueError, match="do not split"):
        multiprocess.local_rows(10, rank=0, world=3)


def test_probe_keys_on_the_cpu():
    first = healthprobe.probe(device="cpu")
    second = healthprobe.probe(device="cpu")
    assert set(first) == set(second) == {"roundtrip_ms", "matmul_ms"}
    assert all(v > 0 for v in second.values())
    with pytest.raises(RuntimeError, match="device='cuda'"):
        healthprobe.probe()


def test_build_meter_rises_across_a_host_build(tmp_path, monkeypatch):
    monkeypatch.setattr(host_build, "BUILD_DIR", str(tmp_path))
    before, total = BuildMeter.seconds("g++"), BuildMeter.seconds()
    path, seconds, _ = host_build.build()
    assert os.path.dirname(path) == str(tmp_path) and seconds > 0
    assert BuildMeter.seconds("g++") == pytest.approx(before + seconds)
    assert BuildMeter.seconds() == pytest.approx(total + seconds)
    assert BuildMeter.report()["g++"]["count"] >= 1
    _, again, _ = host_build.build()  # reused: no build, nothing metered
    assert again == 0.0 and BuildMeter.seconds("g++") == pytest.approx(before + seconds)
    with torch.no_grad():
        panet.FoldedConv(3, 8, 3, 1)(torch.zeros(1, 3, 5, 5))  # a CPU conv: no cuDNN start-up
    assert "cudnn_first_call" not in BuildMeter.report()


def test_entry_on_the_cpu_is_forward_sym():
    fn, args = dryrun.entry(device="cpu")
    d12, d21 = fn(*args)
    assert d12.shape == d21.shape == (64, 2)
    assert args[0].shape == args[1].shape == (64, 33, 33, 3)
    variables = panet.fold_normalize_variables(panet.fold_bn_variables(panet.init_variables(0)))
    model = panet.PANet(torch.bfloat16)
    model.load_state_dict(panet.from_jax_variables(variables))
    with torch.no_grad():
        w12, w21 = model.eval().forward_sym(*args)
    assert torch.equal(d12, w12) and torch.equal(d21, w21)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        dryrun.entry()


@pytest.mark.parametrize("mode", ["crop", "grid"])
def test_bench_torch_counts_bench_py_flops(mode):
    sys.path.insert(0, ROOT)
    import bench
    import bench_torch

    assert bench_torch.flops_per_match(mode) == bench.flops_per_match(mode)
    assert bench_torch.N_MATCHES == bench.N_MATCHES
