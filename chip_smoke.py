#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (lfr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its seconds; any failure ends the run non-zero:

1. device:  needs a CUDA device; prints the card's name and power limit and
   the TF32 and cuDNN settings (``cudnn.benchmark`` off, the library's
   default).
2. build:   nvcc builds lfr_tpu_torch/csrc/correlation.cu for sm_90a into
   lfr_tpu_torch/_build/ (plain-C library loaded with ctypes).
3. kernels: each of the four correlation kernels on seeded inputs (asym,
   nonorm and matmul at B=4096, sym at B=2048), held against its plain
   PyTorch version; kernel, plain-version and one-PyTorch-call
   (``library_ms``) times from CUDA events, beside the least time the card
   could take (``bound_ms``); each kernel's line also carries the time of
   the previous kernel design, the WMMA kernel with f32 row staging that
   this one replaced (``ms_pr5``, a constant, NVIDIA H100 80GB HBM3 at
   700 W).
4. conv_rounding: FoldedConv on the card at each of the 12 conv shapes of
   the main path (lfr_tpu_torch.models.panet.MAIN_PATH_CONVS, batch 16),
   against the one-rounding result bf16(max(conv_f32 + bias, 0)) from an
   f32 conv of the same bf16 operands with TF32 off; fails where more than
   CONV_DIFFER_SHARE of a layer's elements differ.
5. slice:   TwoViewRefiner on bench.py's workload (480x640 shifted pair,
   2048 matches, batch 2048, PANet weights from weights/panet_holdout.msgpack
   read by the port's own reader), fine_mode "crop" then "grid": one warm-up
   and 3 timed calls each; the first 64 matches are held against the same
   port on the CPU in f32.  Its launches count for the path "two_view".
6. match_graph: compute_match_graph on a scene written to a temporary
   directory by synthetic.match_graph_workload: 8 PNG views of 1334x2000
   (1067x1600 after the sift caps), 4096 planted keypoints each, the 28
   pairs of an exhaustive list, fine_mode "crop", batches of 2048.  The
   written MatchingFile is decoded and checked against the scene's ground
   truth, the port's CPU matchers and a CPU f32 refinement of 64 matches.
7. variants: scripts/bench_corr_variants_torch.py's run (asym, nonorm and
   matmul kernels and two PyTorch calls at B=4096).
8. the kernel list as one JSON line, the card's name and power limit, and
   the result line ``{"ok": true, "device": {...}}`` last.

Each path's kernel launches are counted from 0 just before it runs and read
just after; every kernel must be launched on at least one path.

Imports torch, numpy and lfr_tpu_torch only.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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

#: A match that the card's and the CPU's matchers disagree on must sit
#: within this of a decision (a top-2 similarity gap, or a ratio against the
#: threshold): f32 products summed in another order differ by ~1e-7.
NEAR_TIE = 1e-5

#: Share of a conv layer's elements in which FoldedConv may differ from the
#: one-rounding result: where cuDNN sums in another order than the f32
#: reference, the sum may lie within its own f32 error of a bf16 rounding
#: boundary.  scripts/probe_torch_conv_epilogue.py read 1.3e-4 to 2.2e-3 on
#: the card (the most on head conv0, 7,225-term sums); the two-pass epilogue
#: the port had before, which rounds twice, differs in 10-16%.
CONV_DIFFER_SHARE = 5e-3

#: Each kernel's time in the previous design (the WMMA kernel with f32 row
#: staging), measured by this script (NVIDIA H100 80GB HBM3,
#: 700 W; PERF.md), printed beside this run's in the kernel phase.
MS_PREVIOUS_DESIGN = {"corr_asym": 1.3493, "corr_sym": 1.2721, "corr_nonorm": 1.0089,
          "corr_matmul": 1.0008}

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

    # Yardsticks only: the port never calls them.
    def library_norm(a, b):
        return F.normalize(torch.bmm(a, b.transpose(1, 2)).relu_(), dim=-1)

    def library_relu(a, b):
        return torch.bmm(a, b.transpose(1, 2)).relu_()

    def library_matmul(a, b):
        return torch.bmm(a, b.transpose(1, 2))

    # name, batch, views, (kernel, plain, library) as functions of (fr, ft),
    # each returning a tuple of volumes, file:line of the TPU kernel.
    specs = (
        ("corr_asym", 4096, 1, (
            lambda fr, ft: (correlation.correlation_asym(fr, ft),),
            lambda fr, ft: (correlation.correlation_reference(fr, ft, sym=False),),
            library_norm,
        ), "lfr_tpu/ops/correlation.py:102"),
        ("corr_sym", 2048, 2, (
            correlation.correlation_sym,
            correlation.correlation_reference,
            lambda fr, ft: (library_norm(fr, ft), library_norm(ft, fr)),
        ), "lfr_tpu/ops/correlation.py:93"),
        ("corr_nonorm", 4096, 1, (
            lambda fr, ft: (correlation.correlation_nonorm(fr, ft),),
            lambda fr, ft: (correlation._relu_corr(fr, ft),),
            library_relu,
        ), "scripts/bench_corr_variants.py:59"),
        ("corr_matmul", 4096, 1, (
            lambda fr, ft: (correlation.correlation_matmul(fr, ft),),
            lambda fr, ft: (correlation._corr(fr, ft),),
            library_matmul,
        ), "scripts/bench_corr_variants.py:64"),
    )

    rows = []
    for name, batch, views, fns, replaces in specs:
        fr, ft = feats(batch), feats(batch)
        kernel, plain, library = (lambda f=f: f(fr, ft) for f in fns)
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
        nbytes = 2 * batch * 289 * 128 * 2 + views * batch * 289 * 289 * 2
        flops = views * 2.0 * batch * 289 * 289 * 128
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOP_PER_S * 1e3
        row = {
            "name": name,
            "route": "cuda",
            "source": "lfr_tpu_torch/csrc/correlation.cu",
            "replaces": replaces,
            "batch": batch,
            "max_abs_err": err,
            "ms": time_ms(kernel),
            "plain_ms": time_ms(plain),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(library),
        }
        row["ms_pr5"] = MS_PREVIOUS_DESIGN[name]
        print(json.dumps({"kernel_check": row}), flush=True)
        rows.append(row)
        del fr, ft
        torch.cuda.empty_cache()
    return rows


def conv_rounding_phase():
    """FoldedConv at the main path's conv shapes against one rounding."""
    import torch
    import torch.nn.functional as F

    from lfr_tpu_torch.models.panet import MAIN_PATH_CONVS, FoldedConv

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    with torch.inference_mode():
        for name, cin, cout, size, k, pad in MAIN_PATH_CONVS:
            if cin == 289:  # the head's input: a permuted view of the (B, 17, 17, 289) volume
                x = torch.rand(16, size, size, cin, generator=gen, device="cuda")
                x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
            else:
                x = torch.rand(16, cin, size, size, generator=gen, device="cuda")
                x = x * 255 if cin == 3 else x  # raw pixels
                x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            conv = FoldedConv(cin, cout, k, pad).cuda()
            conv.weight.copy_(torch.randn(cout, cin, k, k, generator=gen, device="cuda")
                              / (cin * k * k) ** 0.5)
            conv.bias.copy_(torch.randn(cout, generator=gen, device="cuda") * 0.5)
            got = conv(x).float()
            w = conv.weight.to(torch.bfloat16).float()
            if torch.backends.cudnn.allow_tf32:
                raise RuntimeError("conv_rounding: the reference needs TF32 off")
            exact = F.conv2d(x.float(), w, padding=pad).add_(conv.bias.view(1, -1, 1, 1))
            exact = exact.relu_().to(torch.bfloat16).float()
            two_pass = F.conv2d(x, w.to(torch.bfloat16), padding=pad)
            two_pass = two_pass.add_(conv.bias.view(1, -1, 1, 1)).relu_().float()
            row = {
                "layer": name,
                "padded_channels": cin % 8 != 0,
                "elements": got.numel(),
                "differ_share": (got != exact).float().mean().item(),
                "max_rel": ((got - exact).abs() / exact.abs().clamp_min(1e-3)).max().item(),
                "two_pass_differ_share": (two_pass != exact).float().mean().item(),
            }
            print(json.dumps({"conv_rounding": row}), flush=True)
            if got.shape != exact.shape or not row["differ_share"] <= CONV_DIFFER_SHARE:
                raise RuntimeError(f"conv_rounding: {name} differs from one rounding: {row}")
            rows.append(row)
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
        want = {"corr_sym": calls * chunks, "corr_asym": 9 * calls * chunks,
                "corr_nonorm": 0, "corr_matmul": 0}
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


def match_graph_phase(correlation):
    """compute_match_graph on the synthetic scene, then the checks."""
    import torch

    from lfr_tpu_torch.config import get_method
    from lfr_tpu_torch.io import features as features_io
    from lfr_tpu_torch.io import images as images_io
    from lfr_tpu_torch.io import match_list as match_list_io
    from lfr_tpu_torch.io import protos
    from lfr_tpu_torch.models.checkpoint import load_variables
    from lfr_tpu_torch.ops import matchers
    from lfr_tpu_torch.pipelines.match_graph import compute_match_graph
    from lfr_tpu_torch.pipelines.refinement import TwoViewRefiner
    from lfr_tpu_torch.utils import synthetic

    variables = load_variables(os.path.join(HERE, "weights", "panet_holdout.msgpack"))
    method = get_method("sift")
    tmp = tempfile.mkdtemp(prefix="lfr_match_graph_")
    try:
        t0 = time.perf_counter()
        scene = synthetic.match_graph_workload(np.random.default_rng(1), tmp)
        print(f"match_graph: wrote {len(scene['images'])} PNG views in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        output = os.path.join(tmp, "matches.pb")
        refiner = TwoViewRefiner(variables, batch_size=BATCH, fine_mode="crop", device="cuda")
        spans = {}
        torch.cuda.reset_peak_memory_stats()
        correlation.reset_launches()
        t0 = time.perf_counter()
        written = compute_match_graph(tmp, scene["match_list"], method, output,
                                      refiner=refiner, sub_spans=spans, progress=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(correlation.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30

        batches = spans["refine_dispatch"]["calls"]
        want = {"corr_sym": batches, "corr_asym": 9 * batches, "corr_nonorm": 0,
                "corr_matmul": 0}
        if counts != want:
            raise RuntimeError(f"match_graph: kernel launches {counts}, expected {want}")
        names = scene["images"]
        pairs = protos.read_matching_file(output)
        order = [(p.image_name1, p.image_name2) for p in pairs]
        if written != [output] or order != match_list_io.exhaustive_pairs(names):
            raise RuntimeError(f"match_graph: wrote {written}, pairs {order}")

        feats = [features_io.load_features(os.path.join(tmp, n), method.name) for n in names]
        n_matches = near_ties = 0
        centers = []
        for p in pairs:
            a, b = names.index(p.image_name1), names.index(p.image_name2)
            ids_a, ids_b = scene["point_ids"][a], scene["point_ids"][b]
            m = p.matches.astype(np.int64)
            if not np.array_equal(ids_a[m[:, 0]], ids_b[m[:, 1]]):
                raise RuntimeError(f"match_graph: {p.image_name1}-{p.image_name2} joins "
                                   "different canvas points")
            true = len(np.intersect1d(ids_a, ids_b))
            if not 2 * len(m) >= true:
                raise RuntimeError(f"match_graph: {p.image_name1}-{p.image_name2} kept "
                                   f"{len(m)} of {true} true correspondences")
            for g in (p.disp1, p.disp2):
                if g.shape != (len(m), 3, 3, 2) or not np.isfinite(g).all():
                    raise RuntimeError(f"match_graph: bad flow grids {g.shape}")
            d1, d2 = feats[a].descriptors, feats[b].descriptors
            cpu, _ = matchers.match(d1, d2, method.matcher, method.threshold, device="cpu")
            differ = set(map(tuple, m)) ^ set(map(tuple, cpu))
            for i, j in differ:
                if not matchers.decision_margin(d1, d2, i, j, method.threshold) < NEAR_TIE:
                    raise RuntimeError(f"match_graph: match ({i}, {j}) of "
                                       f"{p.image_name1}-{p.image_name2} differs from the "
                                       "CPU matcher and is no near-tie")
            near_ties += len(differ)
            n_matches += len(m)
            centers.append(np.abs(p.disp2[:, 1, 1]))
        center_px = float(np.median(np.concatenate(centers))) * 16.0
        if not center_px < CENTER_FLOW_MEDIAN_PX:
            raise RuntimeError(f"match_graph: median center flow {center_px} px")

        # The first N_CPU matches of pair 0 again, on the CPU in f32.
        first = pairs[0]
        a, b = names.index(first.image_name1), names.index(first.image_name2)
        img_a, fact_a = images_io.load_and_downscale(
            os.path.join(tmp, names[a]), method.max_edge, method.max_sum_edges)
        img_b, fact_b = images_io.load_and_downscale(
            os.path.join(tmp, names[b]), method.max_edge, method.max_sum_edges)
        cpu_ref = TwoViewRefiner(variables, batch_size=N_CPU, compute_dtype=torch.float32,
                                 fine_mode="crop", device="cpu")
        c12, c21 = cpu_ref.refine_matches(
            img_a, feats[a].xy / fact_a, img_b, feats[b].xy / fact_b,
            first.matches[:N_CPU].astype(np.int64))
        err = max(np.abs(first.disp2[:N_CPU] - c12).max(),
                  np.abs(first.disp1[:N_CPU] - c21).max())
        if not err <= SLICE_ATOL:
            raise RuntimeError(f"match_graph: max |card - CPU f32| = {err} > {SLICE_ATOL} units")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    decode = spans.get("host_decode", {}).get("total_s", 0.0)
    result = {
        "pairs": len(pairs),
        "matches": n_matches,
        "image_hw": list(img_a.shape[:2]),
        "pairs_per_s": len(pairs) / seconds,
        "matches_per_s": n_matches / seconds,
        "seconds": seconds,
        "seconds_without_decode": seconds - decode,
        "decode_note": "host_decode reads PNGs written with filter 0 (None) on every row",
        "peak_mem_gib": peak,
        "median_center_flow_px": center_px,
        "max_abs_vs_cpu_f32_units": float(err),
        "near_ties_vs_cpu_matcher": near_ties,
        "launches": counts,
        "sub_spans": spans,
    }
    print(json.dumps({"match_graph": result}), flush=True)
    return counts, result


def variants_phase(correlation):
    """scripts/bench_corr_variants_torch.py's path at B=4096."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import bench_corr_variants_torch

    correlation.reset_launches()
    lines = bench_corr_variants_torch.run()
    counts = dict(correlation.LAUNCHES)
    print(json.dumps({"variants": lines, "launches": counts}), flush=True)
    return counts


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
    # The library's default, as the port runs: with benchmark on, cuDNN times
    # its fused conv engines for 10-19 s at each new shape (PERF.md).
    torch.backends.cudnn.benchmark = False
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
    conv_rounding_phase()
    phase("conv_rounding", t0)

    paths = {}
    t0 = time.perf_counter()
    paths["two_view"], _ = slice_phase(correlation)
    phase("slice", t0)

    t0 = time.perf_counter()
    paths["match_graph"], _ = match_graph_phase(correlation)
    phase("match_graph", t0)

    t0 = time.perf_counter()
    paths["variants"] = variants_phase(correlation)
    phase("variants", t0)

    for row in rows:
        row["launches_by_path"] = {path: counts[row["name"]] for path, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] == 0:
            raise RuntimeError(f"{row['name']} was launched on no path")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(f"total: {time.perf_counter() - t_all:.3f} s")
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
