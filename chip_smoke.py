#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (lfr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its seconds; any failure ends the run non-zero:

1. device:  needs a CUDA device; prints the card's name and power limit and
   the TF32 settings.
2. build:   nvcc builds lfr_tpu_torch/csrc/correlation.cu for sm_90a into
   lfr_tpu_torch/_build/ (plain-C library loaded with ctypes).
3. kernels: each correlation kernel at its main-path shape (asym B=4096,
   sym B=2048) on seeded inputs, held against its plain PyTorch version;
   kernel, plain-version and one-PyTorch-call (``library_ms``) times from
   CUDA events, beside the least time the card could take (``bound_ms``).
4. slice:   TwoViewRefiner on bench.py's workload (480x640 shifted pair,
   2048 matches, batch 2048, PANet weights from weights/panet_holdout.msgpack
   read by the port's own reader), fine_mode "crop" then "grid": one warm-up
   and 3 timed calls each, with the launch counters set to 0 just before and
   read just after; the first 64 matches are held against the same port on
   the CPU in f32.
5. the kernel list as one JSON line, the card's name and power limit, and
   the result line ``{"ok": true, "device": {...}}`` last.

Imports torch, numpy and lfr_tpu_torch only.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

#: max |kernel - plain| on the bf16 volume: the kernel rounds each value
#: (<= 1) to bf16 (half-ulp 2^-9 ~ 2e-3); the rest is f32 summation order.
KERNEL_ATOL = 8e-3

#: max |card - CPU f32| on the refined flow grids, in displacement units
#: (1 unit = 16 px).  The card runs the CNN in bf16; the same port in bf16
#: on the CPU differs from f32 by at most 2.4e-3 units on these 64 matches,
#: and the card read 2.1e-3 to 2.8e-3 units.  0.008 units = 0.13 px leaves
#: room above those readings and stays near the JAX package's own bf16-vs-f32
#: figure (~4e-3 units).
SLICE_ATOL = 0.008

#: The workload's matches are exact (kps2 = kps1 + the pair's shift), so the
#: refined flow at each keypoint should be near 0; the CPU f32 port gives a
#: median of 0.09 px (crop) and 0.13 px (grid) on the first 64 matches.
CENTER_FLOW_MEDIAN_PX = 0.5

BATCH = 2048
REPS = 3
N_CPU = 64


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs=20, warmup=3):
    """Median of ``runs`` CUDA-event timings of fn(), after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernel_phase(correlation):
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)

    def feats(b):
        x = torch.randn(b, correlation.POS, correlation.CHANNELS, generator=gen, device="cuda")
        return F.normalize(x, dim=-1).to(torch.bfloat16)

    def library_call(a, b):  # yardstick only: the port never calls it
        return F.normalize(torch.bmm(a, b.transpose(1, 2)).relu_(), dim=-1)

    rows = []
    for name, batch, sym in (("corr_asym", 4096, False), ("corr_sym", 2048, True)):
        fr, ft = feats(batch), feats(batch)
        if sym:
            kernel = lambda: correlation.correlation_sym(fr, ft)  # noqa: E731
            plain = lambda: correlation.correlation_reference(fr, ft)  # noqa: E731
            library = lambda: (library_call(fr, ft), library_call(ft, fr))  # noqa: E731
        else:
            kernel = lambda: (correlation.correlation_asym(fr, ft),)  # noqa: E731
            plain = lambda: (correlation.correlation_reference(fr, ft, sym=False),)  # noqa: E731
            library = lambda: library_call(fr, ft)  # noqa: E731
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
        for g in got:
            if g.shape != (batch, 289, 289) or g.dtype != torch.bfloat16:
                raise RuntimeError(f"{name}: output {tuple(g.shape)} {g.dtype}")
        if not err <= KERNEL_ATOL:
            raise RuntimeError(f"{name}: max |kernel - plain| = {err} > {KERNEL_ATOL}")
        del got, want
        views = 2 if sym else 1
        nbytes = 2 * batch * 289 * 128 * 2 + views * batch * 289 * 289 * 2
        flops = views * 2.0 * batch * 289 * 289 * 128
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOP_PER_S * 1e3
        row = {
            "name": name,
            "route": "cuda",
            "source": "lfr_tpu_torch/csrc/correlation.cu",
            "replaces": "lfr_tpu/ops/correlation.py:93" if sym else "lfr_tpu/ops/correlation.py:102",
            "batch": batch,
            "max_abs_err": err,
            "ms": time_ms(kernel),
            "plain_ms": time_ms(plain),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(library),
        }
        print(json.dumps({"kernel_check": row}), flush=True)
        rows.append(row)
        del fr, ft
        torch.cuda.empty_cache()
    return rows


def slice_phase(correlation):
    import torch

    from lfr_tpu_torch.models.checkpoint import load_variables
    from lfr_tpu_torch.pipelines.refinement import TwoViewRefiner, prepare_image
    from lfr_tpu_torch.utils import synthetic

    variables = load_variables(os.path.join(HERE, "weights", "panet_holdout.msgpack"))
    image1, image2, kps1, kps2, matches = synthetic.bench_workload(np.random.default_rng(0))
    n_matches = len(matches)
    chunks = -(-n_matches // BATCH)
    prep1 = prepare_image(image1, "cuda")
    prep2 = prepare_image(image2, "cuda")

    launches = {key: 0 for key in correlation.LAUNCHES}
    results = {}
    for mode in ("crop", "grid"):
        t0 = time.perf_counter()
        refiner = TwoViewRefiner(variables, batch_size=BATCH, fine_mode=mode, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        correlation.reset_launches()
        refiner.refine_matches(prep1, kps1, prep2, kps2, matches)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        handles = [
            refiner.refine_matches_async(prep1, kps1, prep2, kps2, matches) for _ in range(REPS)
        ]
        outs = [refiner.resolve_refined(h) for h in handles]
        dt = (time.perf_counter() - t1) / REPS
        counts = dict(correlation.LAUNCHES)
        calls = REPS + 1
        want = {"corr_sym": calls * chunks, "corr_asym": 9 * calls * chunks}
        if counts != want:
            raise RuntimeError(f"{mode}: kernel launches {counts}, expected {want}")
        for key in launches:
            launches[key] += counts[key]
        g12, g21 = outs[-1]
        for g in (g12, g21):
            if g.shape != (n_matches, 3, 3, 2) or not np.isfinite(g).all():
                raise RuntimeError(f"{mode}: bad output {g.shape}, finite={np.isfinite(g).all()}")
        center_px = float(np.median(np.abs(g12[:, 1, 1]))) * 16.0
        if not center_px < CENTER_FLOW_MEDIAN_PX:
            raise RuntimeError(f"{mode}: median center flow {center_px} px on exact matches")

        cpu = TwoViewRefiner(variables, batch_size=N_CPU, compute_dtype=torch.float32,
                             fine_mode=mode, device="cpu")
        c12, c21 = cpu.refine_matches(image1, kps1, image2, kps2, matches[:N_CPU])
        err = max(np.abs(g12[:N_CPU] - c12).max(), np.abs(g21[:N_CPU] - c21).max())
        if not err <= SLICE_ATOL:
            raise RuntimeError(f"{mode}: max |card - CPU f32| = {err} > {SLICE_ATOL} units")
        results[mode] = {
            "matches_per_s": n_matches / dt,
            "seconds_per_call": dt,
            "launches": counts,
            "max_abs_vs_cpu_f32_units": float(err),
            "median_center_flow_px": center_px,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
        print(json.dumps({"slice": mode, **results[mode]}), flush=True)
        phase(f"slice {mode}", t0)
    return launches, results


def main() -> int:
    t_all = time.perf_counter()
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from lfr_tpu_torch.ops import correlation, cuda_build

    card = gpu_name_and_power()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark}",
        flush=True,
    )
    phase("device", t0)

    t0 = time.perf_counter()
    path, seconds, log = cuda_build.build()
    print(f"built {os.path.relpath(path, HERE)} in {seconds:.3f} s", flush=True)
    print(log.strip(), flush=True)
    cuda_build.library()
    phase("build", t0)

    t0 = time.perf_counter()
    rows = kernel_phase(correlation)
    phase("kernels", t0)

    t0 = time.perf_counter()
    launches, _ = slice_phase(correlation)
    phase("slice", t0)

    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] == 0:
            raise RuntimeError(f"{row['name']} was not launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(f"total: {time.perf_counter() - t_all:.3f} s")
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
