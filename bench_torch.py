"""Benchmark of the PyTorch / CUDA port: two-view refinement throughput.

    python bench_torch.py            # on the card (needs CUDA)

The workload of bench.py (which stays the JAX package's): 2,048 exact
matches of one 480x640 shifted pair, refined coarse to fine by
``lfr_tpu_torch.pipelines.refinement.TwoViewRefiner`` at batch 2,048 in
bf16, fine mode "crop" (``LFR_BENCH_FINE_MODE=grid`` for the other), with
the best weights under weights/.  One warm-up call, then REPS calls
dispatched together and resolved, as bench.py measures sustained
throughput.

Prints ONE JSON line: ``metric``, ``value`` (matches/s), ``unit``, the
fine mode, the model FLOPs of one match (bench.py's count), the achieved
TFLOP/s and their share of the card's dense bf16 peak (the NVIDIA H100 SXM
datasheet's 989.4 TFLOP/s; null on any other card), and the card's name
and power limit as ``nvidia-smi`` reports them.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

#: NVIDIA H100 SXM5 datasheet: dense bf16 tensor-core peak, FLOP/s.
H100_SXM_BF16_DENSE_PEAK = 989.4e12

N_MATCHES = 2048
REPS = 6


def _conv_flops(h, w, kh, kw, cin, cout):
    return h * w * kh * kw * cin * cout * 2


def flops_per_match(fine_mode: str = "grid") -> float:
    """Executed model FLOPs of one refined match: coarse sym + the fine
    pass (bench.py's count).

    ``grid``: 18 asym passes, each a full backbone + correlation + head.
    ``crop``: the backbone runs once per 65x65 crop (4 crops/match); the
    nine per-direction grid patches are served from feature-map slices, so
    only 18 correlation + head evaluations remain.
    """
    backbone = (
        _conv_flops(33, 33, 3, 3, 3, 64)
        + _conv_flops(33, 33, 3, 3, 64, 64)
        + _conv_flops(17, 17, 3, 3, 64, 128)
        + _conv_flops(17, 17, 3, 3, 128, 128)
    )
    crop_backbone = (
        _conv_flops(65, 65, 3, 3, 3, 64)
        + _conv_flops(65, 65, 3, 3, 64, 64)
        + _conv_flops(33, 33, 3, 3, 64, 128)
        + _conv_flops(33, 33, 3, 3, 128, 128)
    )
    head = (
        _conv_flops(13, 13, 5, 5, 289, 128)
        + _conv_flops(9, 9, 5, 5, 128, 128)
        + _conv_flops(5, 5, 5, 5, 128, 64)
        + _conv_flops(1, 1, 5, 5, 64, 64)
        + 64 * 2 * 2
    )
    corr = 289 * 289 * 128 * 2
    coarse = 2 * backbone + corr + 2 * head
    if fine_mode == "crop":
        fine = 4 * crop_backbone + 18 * (corr + head)
    else:
        fine = 18 * (2 * backbone + corr + head)
    return float(coarse + fine)


def _weights():
    """The best weights under weights/, read by the port's own reader."""
    from lfr_tpu_torch.models.checkpoint import load_variables

    here = os.path.dirname(os.path.abspath(__file__))
    for name in ("panet_holdout.msgpack", "panet_real.msgpack", "panet_cpu.msgpack"):
        path = os.path.join(here, "weights", name)
        if os.path.exists(path):
            return load_variables(path)
    raise FileNotFoundError("no PANet weights under weights/")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> dict:
    import torch

    from lfr_tpu_torch.pipelines.refinement import TwoViewRefiner, prepare_image
    from lfr_tpu_torch.utils import synthetic

    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py needs a CUDA device")
    image1, image2, kps1, kps2, matches = synthetic.bench_workload(np.random.default_rng(0))
    fine_mode = os.environ.get("LFR_BENCH_FINE_MODE", "crop")
    refiner = TwoViewRefiner(_weights(), batch_size=N_MATCHES, fine_mode=fine_mode, device="cuda")
    prep1 = prepare_image(image1, "cuda")
    prep2 = prepare_image(image2, "cuda")

    refiner.refine_matches(prep1, kps1, prep2, kps2, matches)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [refiner.refine_matches_async(prep1, kps1, prep2, kps2, matches)
               for _ in range(REPS)]
    results = [refiner.resolve_refined(h) for h in handles]
    dt = (time.perf_counter() - t0) / REPS
    g12, g21 = results[-1]
    assert np.isfinite(g12).all() and np.isfinite(g21).all()

    value = len(matches) / dt
    fpm = flops_per_match(fine_mode)
    achieved = value * fpm
    name = torch.cuda.get_device_name(0)
    is_h100 = "H100" in name
    line = {
        "metric": "two_view_refinement_throughput",
        "value": value,
        "unit": "matches/s",
        "fine_mode": fine_mode,
        "gflops_per_match": fpm / 1e9,
        "achieved_tflops": achieved / 1e12,
        "peak_tflops_bf16_dense": H100_SXM_BF16_DENSE_PEAK / 1e12 if is_h100 else None,
        "peak_source": "NVIDIA H100 SXM datasheet, dense bf16" if is_h100 else None,
        "mfu_pct_bf16_peak": 100.0 * achieved / H100_SXM_BF16_DENSE_PEAK if is_h100 else None,
        "card": _card(),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
