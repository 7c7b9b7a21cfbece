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
   The file stays for the solve phase.
7. solve: the multi-view solver (lfr_tpu_torch.solver, torch ops on the
   card, no kernel of ours).  (a) solve_file on the match graph's
   MatchingFile; the SolutionFile must hold one image per image in
   first-seen order with each image's features in first-seen order, agree
   with the port's CPU solve (at most SOLVE_DIFFER_SHARE of the nodes off
   by more than SOLVE_CPU_ATOL units), and a second card solve must write
   the same bytes; a lane whose damped system is indefinite must end after
   one step at its start.  (b) solve_matches on SOLVE_GRAPHS (the
   full-size and the noisy synthetic graph); on their clean intra-track
   edges the residual median and 99th percentile must stay under
   RESIDUAL_MEDIAN and RESIDUAL_P99, the same positions rounded to bf16 and
   a solve cut to RESIDUAL_CONTROL_STEPS steps must not, and the noisy
   graph's partition must cut.  One ``{"solve": ...}`` line per run with seconds, nodes and edges
   per second, sub_spans, stragglers, the |x| > 0.5 count and peak memory.
8. triangulation: the fixed-pose chain (lfr_tpu_torch.pipelines.triangulation:
   import with batched F + H RANSAC, union-find tracks, batched DLT +
   Gauss-Newton; torch ops on the card, no kernel of ours) on
   synthetic.triangulation_workload.  (a) The full-size scene (TRI_SCENE:
   30 ETH3D DSLR cameras, 20,000 points, 0.5 px noise, 10% rewired
   matches), raw then ref (the planted SolutionFile): one
   ``{"triangulation": ...}`` line per run with the spans, pairs/s of
   verification, tracks/s of the device triangulation, analyze_model's
   stats, the median point error against the ground truth and the share of
   rewired matches that survive verification.  Gates: every image
   registered; ref's mean reprojection error and median point error below
   raw's; ref's median point error under POINT_ERROR_MEDIAN, which the raw
   database triangulated with 0 Gauss-Newton steps must fail; at most
   REWIRED_SURVIVE_SHARE of the rewired matches survive, which every
   putative match taken as an inlier must fail.  (b) The small scene
   (TRI_SMALL_SCENE), ref, twice on the card and once on the CPU with the
   same samples: every pair's configuration equal, inlier sets equal except
   matches within NEAR_THRESHOLD of a verification threshold, kept points
   equal except gate near-ties (at most GATE_DIFFER_SHARE of the points),
   xyz within XYZ_DEPTH_RTOL of the depth; the two card runs write the same
   bytes into two_view_geometries and points3D.txt.
9. variants: scripts/bench_corr_variants_torch.py's run (asym, nonorm and
   matmul kernels and two PyTorch calls at B=4096).
10. the kernel list as one JSON line, the card's name and power limit, and
   the result line ``{"ok": true, "device": {...}}`` last.

Each path's kernel launches are counted from 0 just before it runs and read
just after; every kernel must be launched on at least one path.

Imports torch, numpy and lfr_tpu_torch (whose solver uses scipy) only.
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

#: The solve on the card against the same port on the CPU: at most
#: SOLVE_DIFFER_SHARE of the nodes may differ by more than SOLVE_CPU_ATOL
#: units.  Both solve in f32; lanes whose cost reaches f32 rounding stop on
#: rounding, so a few may stop at another step.
SOLVE_CPU_ATOL = 1e-4
SOLVE_DIFFER_SHARE = 1e-3

#: On solver_graph's clean intra-track edges, |(x_dst - x_src) - (offset_dst
#: - offset_src)| in units: median and 99th percentile bounds.  They lie
#: between the card's readings (PERF.md) and those of controls that must fail
#: them: the card's positions rounded to bf16, and the LM cut to
#: RESIDUAL_CONTROL_STEPS steps.  Two steps are no control: on constant flows
#: the first (lam 1e-4) leaves about 1e-4 of each offset, the second reaches
#: f32 rounding, a right answer.
RESIDUAL_MEDIAN = 1e-6
RESIDUAL_P99 = 2e-4
RESIDUAL_CONTROL_STEPS = 1

#: Part (b)'s graphs, synthetic.solver_graph(np.random.default_rng(0), ...):
#: scripts/bench_solver.py's second graph (the README's 30-camera scene,
#: ~150k nodes, 2.2M directed edges), and a 12-image graph with 5% of each
#: pair's matches rewired, for MSF rejections, inter-track edges, cuts and
#: stragglers.
SOLVE_GRAPHS = (("full", dict(n_images=30, n_points=10000)),
                ("noisy", dict(n_images=12, n_points=3000, outlier_share=0.05)))

#: The triangulation phase's scenes: synthetic.triangulation_workload's
#: full size (README's 30-camera scene) and a small one for card vs CPU.
TRI_SCENE = dict(num_cameras=30, num_points=20000)
TRI_SMALL_SCENE = dict(num_cameras=8, num_points=3000)

#: Median distance of ref's kept points from the ground truth, in scene
#: units (the scene is 6 units deep).  It lies between the card's ref
#: reading (4.41e-4) and the control that must fail it, the raw database
#: triangulated with 0 Gauss-Newton steps (2.21e-3; raw itself 2.22e-3:
#: the DLT is near-optimal at 0.5 px), NVIDIA H100 80GB HBM3 at 700 W
#: (PERF.md).
POINT_ERROR_MEDIAN = 1e-3

#: Share of the rewired (outlier) matches that may survive verification:
#: the card read 1.59% (raw) and 1.69% (ref), along epipolar lines; every
#: putative match taken as an inlier (100%) must fail it.
REWIRED_SURVIVE_SHARE = 0.03

#: Card vs CPU: a match may change sides only if its Sampson / transfer
#: error lies within this (relative) of the 4 px threshold; a point may be
#: kept on one side only if an angle or reprojection gate value lies within
#: it of its bound, and at most GATE_DIFFER_SHARE of the points so; xyz of
#: the points kept by both agree within XYZ_DEPTH_RTOL of their depth.
NEAR_THRESHOLD = 1e-3
GATE_DIFFER_SHARE = 1e-3
XYZ_DEPTH_RTOL = 1e-4

#: Steps of the failed-Cholesky check.
LM_CHECK_ITER = 4

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
        ), "scripts/bench_corr_variants.py:56"),
        ("corr_matmul", 4096, 1, (
            lambda fr, ft: (correlation.correlation_matmul(fr, ft),),
            lambda fr, ft: (correlation._corr(fr, ft),),
            library_matmul,
        ), "scripts/bench_corr_variants.py:61"),
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


def match_graph_phase(correlation, tmp):
    """compute_match_graph on the synthetic scene written to ``tmp``, then
    the checks.  The MatchingFile stays in ``tmp`` for the solve phase."""
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
    return counts, output


def _solve_run(name, fn):
    """Run one solve on the card; returns (result line, sub_spans)."""
    import torch

    spans = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn(spans)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    line = {
        "run": name,
        "seconds": seconds,
        "nodes": spans["n_nodes"],
        "edges": spans["n_edges"],
        "nodes_per_s": spans["n_nodes"] / seconds,
        "edges_per_s": spans["n_edges"] / seconds,
        "n_stragglers": spans["n_stragglers"],
        "n_outside_half_unit": spans["n_outside"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "sub_spans": spans,
    }
    return line, spans


def _expected_layout(pairs):
    """Image names in first-seen order and each image's features in
    first-seen order, from the pairs' matches alone."""
    order = {}
    for p in pairs:
        if p.num_matches:
            for name, feats in ((p.image_name1, p.matches[:, 0]), (p.image_name2, p.matches[:, 1])):
                order.setdefault(name, []).append(feats.astype(np.int64))
    layout = {}
    for name, chunks in order.items():
        feats = np.concatenate(chunks)
        _, first = np.unique(feats, return_index=True)
        layout[name] = feats[np.sort(first)]
    return layout


def _node_positions(graph, solutions):
    """(N, 2) positions of the graph's nodes from decoded ImageSolutions."""
    positions = np.full((graph.num_nodes, 2), np.nan, dtype=np.float32)
    index = {name: i for i, name in enumerate(graph.image_names)}
    for sol in solutions:
        nodes = np.nonzero(graph.node_image == index[sol.image_name])[0]
        if not np.array_equal(graph.node_feature[nodes], sol.feature_indices):
            raise RuntimeError(f"solve: {sol.image_name}'s features are not in node order")
        positions[nodes] = sol.displacements
    return positions


def _clean_edges(pairs):
    """The graph of ``pairs`` and the mask of its intra-track edges between
    clean matches.  solver_graph's feature p is point p in every image and a
    clean match's flow grid is constant at the points' offset difference, so
    a clean edge joins equal features and its grid centre is offset_dst -
    offset_src."""
    from lfr_tpu_torch.solver import graph as graph_mod
    from lfr_tpu_torch.solver import tracks as tracks_mod

    graph = graph_mod.build_graph(pairs)
    tracks = tracks_mod.build_tracks(graph)
    src, dst = graph.edge_src, graph.edge_dst
    keep = ((graph.node_feature[src] == graph.node_feature[dst])
            & (tracks.track_idx[src] == tracks.track_idx[dst]))
    return graph, keep


def _clean_residuals(graph, keep, x):
    """Median and 99th percentile of |(x_dst - x_src) - (offset_dst -
    offset_src)| over the edges ``keep``, for node positions ``x``."""
    res = (x[graph.edge_dst] - x[graph.edge_src]) - graph.edge_flow[:, 1, 1]
    res = np.linalg.norm(res[keep], axis=1)
    return {"median": float(np.median(res)), "p99": float(np.percentile(res, 99))}


def _passes_residual_gate(r):
    return r["median"] < RESIDUAL_MEDIAN and r["p99"] < RESIDUAL_P99


def solve_phase(matches_file, tmp):
    """The multi-view solve on the card: (a) the match graph's MatchingFile
    through solve_file, against the port on the CPU, twice for identical
    bytes; a failed Cholesky on the card; (b) solver_graph's full-size and
    noisy graphs through solve_matches, with the residual gates."""
    import torch

    from lfr_tpu_torch.io import protos
    from lfr_tpu_torch.solver import buckets, lm, partition
    from lfr_tpu_torch.solver import graph as graph_mod
    from lfr_tpu_torch.solver import tracks as tracks_mod
    from lfr_tpu_torch.solver.solve import solve_file, solve_matches
    from lfr_tpu_torch.utils import synthetic

    lines = {}
    # (a) the chain: MatchingFile -> SolutionFile on the card.
    out1, out2, out_cpu = (os.path.join(tmp, f) for f in ("s1.pb", "s2.pb", "s_cpu.pb"))
    line, _ = _solve_run("chain", lambda sp: solve_file(matches_file, out1, verbose=False,
                                                          sub_spans=sp))
    pairs = protos.read_matching_file(matches_file)
    card = protos.read_solution_file(out1)
    layout = _expected_layout(pairs)
    if [s.image_name for s in card] != list(layout):
        raise RuntimeError(f"solve: images {[s.image_name for s in card]} != {list(layout)}")
    for sol in card:
        if not np.array_equal(sol.feature_indices, layout[sol.image_name]):
            raise RuntimeError(f"solve: {sol.image_name} has {len(sol.feature_indices)} "
                               f"features, the graph {len(layout[sol.image_name])}")
        if sol.displacements.shape != (len(sol.feature_indices), 2) or not np.isfinite(
                sol.displacements).all():
            raise RuntimeError(f"solve: bad displacements for {sol.image_name}")
    t0 = time.perf_counter()
    solve_file(matches_file, out_cpu, device="cpu", verbose=False)
    cpu_s = time.perf_counter() - t0
    diff = np.concatenate([np.abs(a.displacements - b.displacements).max(axis=1)
                           for a, b in zip(card, protos.read_solution_file(out_cpu))])
    n_differ = int((diff > SOLVE_CPU_ATOL).sum())
    line.update(cpu_seconds=cpu_s, max_abs_vs_cpu_units=float(diff.max()),
                nodes_differ_vs_cpu=n_differ)
    if not n_differ <= SOLVE_DIFFER_SHARE * diff.size:
        raise RuntimeError(f"solve: {n_differ} of {diff.size} nodes differ from the CPU solve "
                           f"by more than {SOLVE_CPU_ATOL} units")
    solve_file(matches_file, out2, verbose=False)
    with open(out1, "rb") as f1, open(out2, "rb") as f2:
        line["identical_bytes_second_run"] = f1.read() == f2.read()
    if not line["identical_bytes_second_run"]:
        raise RuntimeError("solve: a second card solve wrote other bytes")

    # A lane whose damped system is indefinite (negative similarities) ends
    # after one step at its start, as JAX's NaN factor makes it.
    g = graph_mod.build_graph(pairs)
    tr = tracks_mod.build_tracks(g)
    batch, _ = next(buckets.iter_packed(g, tr, partition.partition_components(g, tr)))
    batch.edge_sim[0] *= -1.0
    results = {}
    for dev in ("cuda", "cpu"):
        r = lm.lm_solve(*lm.to_device(batch, dev), max_iter=LM_CHECK_ITER)
        results[dev] = [t.cpu().numpy() for t in (r.x, r.iterations, r.done)]
    (x, it, done), (x_cpu, it_cpu, done_cpu) = results["cuda"], results["cpu"]
    line["failed_cholesky_lane"] = {"iterations": int(it[0]), "done": bool(done[0])}
    if not (done[0] and it[0] == 1 and not x[0].any() and it_cpu[0] == 1 and done_cpu[0]):
        raise RuntimeError(f"solve: failed-Cholesky lane {line['failed_cholesky_lane']}")
    print(json.dumps({"solve": line}), flush=True)
    lines["chain"] = line

    # (b) full size, then the noisy graph.
    for name, kwargs in SOLVE_GRAPHS:
        t0 = time.perf_counter()
        pairs = synthetic.solver_graph(np.random.default_rng(0), **kwargs)
        made_s = time.perf_counter() - t0
        out = {}
        line, _ = _solve_run(name, lambda sp: out.update(
            solutions=solve_matches(pairs, verbose=False, sub_spans=sp)))
        line["graph"] = {**kwargs, "made_s": made_s}
        line["partition_stats"] = dict(partition.partition_stats)
        graph, keep = _clean_edges(pairs)
        x = _node_positions(graph, out["solutions"])
        line["clean_intra_edges"] = int(keep.sum())
        line["residual"] = _clean_residuals(graph, keep, x)
        # Controls the gate must reject: the positions as a bf16 LM could at
        # best return them, and the LM cut short.
        controls = {"bf16_positions": _clean_residuals(
            graph, keep, torch.from_numpy(x).bfloat16().float().numpy())}
        short = solve_matches(pairs, max_iter=RESIDUAL_CONTROL_STEPS, verbose=False)
        controls[f"lm_{RESIDUAL_CONTROL_STEPS}_steps"] = _clean_residuals(
            graph, keep, _node_positions(graph, short))
        line["residual_controls"] = controls
        print(json.dumps({"solve": line}), flush=True)
        if not _passes_residual_gate(line["residual"]):
            raise RuntimeError(f"solve {name}: residual {line['residual']} over "
                               f"{RESIDUAL_MEDIAN} / {RESIDUAL_P99}")
        passed = [c for c, r in controls.items() if _passes_residual_gate(r)]
        if passed:
            raise RuntimeError(f"solve {name}: the residual gate passes the controls {passed}")
        if name == "noisy" and not line["partition_stats"]["cuts"] > 0:
            raise RuntimeError("solve noisy: the partition made no cut")
        lines[name] = line
    return lines


def _tri_truth(root, truth):
    """(image name -> id, image id -> point id of each feature) of a
    triangulation_workload dataset."""
    from lfr_tpu_torch.io import colmap_db

    db = colmap_db.ColmapDatabase(os.path.join(root, "database.db"))
    ids = db.image_ids()
    db.close()
    return ids, {ids[n]: pof for n, pof in zip(truth["names"], truth["point_of_feature"])}


def _point_errors(model, point_of, points):
    """Distance of each kept point from the ground-truth point of its first
    observation."""
    return np.array([np.linalg.norm(p.xyz - points[point_of[p.image_ids[0]][p.point2D_idxs[0]]])
                     for p in model.points3D.values()])


def _rewired_survival(db_path, ids, point_of, truth, table):
    """Share of the rewired matches that join two different points and lie
    in ``table`` (``two_view_geometries``: survived verification;
    ``matches``: every putative match)."""
    import sqlite3

    from lfr_tpu_torch.io import colmap_db

    con = sqlite3.connect(db_path)
    rows = {pid: np.frombuffer(data, np.uint32).reshape(-1, 2) for pid, data in con.execute(
        f"SELECT pair_id, data FROM {table} WHERE rows > 0;")}
    con.close()
    outliers = survived = 0
    for (name1, name2), rewired in truth["rewired"].items():
        id1, id2 = ids[name1], ids[name2]
        wrong = rewired[point_of[id1][rewired[:, 0]] != point_of[id2][rewired[:, 1]]]
        kept = rows.get(colmap_db.pair_id_from_image_ids(id1, id2), np.zeros((0, 2), np.uint32))
        if id1 > id2:
            kept = kept[:, ::-1]
        kept = set(map(tuple, kept.tolist()))
        outliers += len(wrong)
        survived += sum(tuple(m) in kept for m in wrong.tolist())
    return survived / max(outliers, 1), outliers


def _tri_run(root, truth, solution, ids, point_of):
    """One triangulation_pipeline run on the card and its readings."""
    import sqlite3

    import torch

    from lfr_tpu_torch.io import colmap_model
    from lfr_tpu_torch.pipelines.triangulation import triangulation_pipeline

    tag = "raw" if solution is None else "ref"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = triangulation_pipeline(root, "sift", truth["matches_file"], solution, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    report = stats["timing"]
    spans = {}
    for s in report:
        spans[s["span"]] = spans.get(s["span"], 0.0) + s["ms"] / 1e3
    model = colmap_model.read_model(os.path.join(root, f"sparse-sift-{tag}"))
    errors = _point_errors(model, point_of, truth["points"])
    db_path = os.path.join(root, f"sift-{tag}.db")
    survive, outliers = _rewired_survival(db_path, ids, point_of, truth, "two_view_geometries")
    con = sqlite3.connect(db_path)
    putative = con.execute("SELECT sum(rows) FROM matches;").fetchone()[0]
    con.close()
    line = {
        "run": tag,
        "seconds": seconds,
        "spans_s": spans,
        "pairs": stats["matching"]["num_putative_pairs"],
        "putative_matches": putative,
        "verify_batches": stats["matching"]["verify_batches"],
        "pairs_per_s_verify": stats["matching"]["num_putative_pairs"] / spans["import_verify/verify"],
        "tracks": stats["num_tracks"],
        "tracks_per_s_device": stats["num_tracks"] / spans["triangulate/device"],
        "stats": stats["triangulation"],
        "inlier_pairs": stats["matching"]["num_inlier_pairs"],
        "inlier_matches": stats["matching"]["num_inlier_matches"],
        "point_error_median": float(np.median(errors)),
        "point_error_p90": float(np.percentile(errors, 90)),
        "rewired_outliers": outliers,
        "rewired_survive_share": survive,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    return line, model


def _gate_values(point, images, cameras):
    """Max pairwise angle (rad) and per-observation reprojection errors (px)
    of a model point, in float64 on the host."""
    from lfr_tpu_torch.io import colmap_model

    centers, errors = [], []
    for iid, fidx in zip(point.image_ids, point.point2D_idxs):
        im = images[iid]
        R = colmap_model.qvec_to_rotmat(im.qvec)
        centers.append(-R.T @ im.tvec)
        x = R @ point.xyz + im.tvec
        fx, fy, cx, cy = cameras[im.camera_id].params
        errors.append(np.linalg.norm([x[0] / x[2] * fx + cx, x[1] / x[2] * fy + cy]
                                     - im.xys[fidx]))
    d = point.xyz - np.array(centers)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    angle = float(np.arccos(np.clip(d @ d.T, -1.0, 1.0)).max())
    return angle, np.array(errors)


def _near_gate(point, images, cameras):
    from lfr_tpu_torch.sfm import triangulate

    angle, errors = _gate_values(point, images, cameras)
    bound = np.deg2rad(triangulate.MIN_TRI_ANGLE_DEG)
    return (abs(angle / bound - 1.0) <= NEAR_THRESHOLD or (
        np.abs(errors / triangulate.MAX_REPROJ_ERROR_PX - 1.0) <= NEAR_THRESHOLD).any())


def _compare_card_cpu(card_root, cpu_root):
    """Card vs CPU on one dataset's ref run: configs, inlier sets up to
    near-threshold matches, points up to gate near-ties, xyz."""
    import torch

    from lfr_tpu_torch.io import colmap_db, colmap_model
    from lfr_tpu_torch.sfm import geometry, verify

    dbs = [colmap_db.ColmapDatabase(os.path.join(r, "sift-ref.db")) for r in (card_root, cpu_root)]
    tvg = []
    for db in dbs:
        rows = {}
        for pid, data, config, F, H in db.connection.execute(
                "SELECT pair_id, data, config, F, H FROM two_view_geometries;"):
            m = np.frombuffer(data, np.uint32).reshape(-1, 2) if data else np.zeros((0, 2))
            rows[pid] = (config, set(map(tuple, m.tolist())),
                         np.frombuffer(F, np.float64).reshape(3, 3),
                         np.frombuffer(H, np.float64).reshape(3, 3))
        tvg.append(rows)
    keypoints = {iid: dbs[0].keypoints(iid) for iid in dbs[0].image_ids().values()}
    differ_matches = near_matches = 0
    for pid, (config, inl, F, H) in tvg[0].items():
        config_cpu, inl_cpu, F_cpu, H_cpu = tvg[1][pid]
        if config != config_cpu:
            raise RuntimeError(f"triangulation: pair {pid} config {config} on the card, "
                               f"{config_cpu} on the CPU")
        differ = np.array(sorted(inl ^ inl_cpu), np.int64).reshape(-1, 2)
        if not len(differ):
            continue
        id1, id2 = colmap_db.image_ids_from_pair_id(pid)
        x1 = torch.from_numpy(keypoints[id1][differ[:, 0], :2].astype(np.float64))
        x2 = torch.from_numpy(keypoints[id2][differ[:, 1], :2].astype(np.float64))
        planar = config == verify.CONFIG_PLANAR_OR_PANORAMIC
        near = np.zeros(len(differ), bool)
        for M in ((H, H_cpu) if planar else (F, F_cpu)):
            error = geometry.homography_error if planar else geometry.sampson_error
            e = error(torch.from_numpy(M.copy()), x1, x2).numpy()
            near |= np.abs(e / verify.MAX_ERROR_PX**2 - 1.0) <= NEAR_THRESHOLD
        if not near.all():
            raise RuntimeError(f"triangulation: pair {pid}: {int((~near).sum())} inliers "
                               "differ between card and CPU away from the threshold")
        differ_matches += len(differ)
        near_matches += int(near.sum())
    for db in dbs:
        db.close()

    models = [colmap_model.read_model(os.path.join(r, "sparse-sift-ref"))
              for r in (card_root, cpu_root)]
    tracks = [{tuple(zip(p.image_ids.tolist(), p.point2D_idxs.tolist())): p
               for p in m.points3D.values()} for m in models]
    only = [(t, tracks[k][t], models[k]) for k in (0, 1) for t in tracks[k].keys() - tracks[1 - k]]
    n_near = sum(_near_gate(p, m.images, m.cameras) for _, p, m in only)
    if n_near < len(only) or len(only) > GATE_DIFFER_SHARE * len(tracks[0]):
        raise RuntimeError(f"triangulation: {len(only)} points kept on one side only, "
                           f"{n_near} of them at gate near-ties")
    worst = 0.0
    for t, p in tracks[0].items():
        if t in tracks[1]:
            im = models[0].images[p.image_ids[0]]
            depth = (colmap_model.qvec_to_rotmat(im.qvec) @ p.xyz + im.tvec)[2]
            worst = max(worst, float(np.abs(p.xyz - tracks[1][t].xyz).max() / depth))
    if not worst <= XYZ_DEPTH_RTOL:
        raise RuntimeError(f"triangulation: xyz differ by {worst} of the depth")
    return {"inlier_matches_differ": differ_matches, "near_threshold": near_matches,
            "points": len(tracks[0]), "points_one_side": len(only),
            "points_gate_near_ties": n_near, "max_xyz_diff_of_depth": worst}


def _geometry_bytes(root):
    import sqlite3

    con = sqlite3.connect(os.path.join(root, "sift-ref.db"))
    rows = con.execute("SELECT * FROM two_view_geometries ORDER BY pair_id;").fetchall()
    con.close()
    with open(os.path.join(root, "sparse-sift-ref", "points3D.txt"), "rb") as fh:
        return rows, fh.read()


def triangulation_phase(tmp):
    """The fixed-pose chain on the card: (a) full size, raw and ref, with the
    gates and their controls; (b) card vs CPU and card vs card on the small
    scene."""
    from lfr_tpu_torch.io import colmap_db, colmap_model
    from lfr_tpu_torch.pipelines.triangulation import triangulation_pipeline
    from lfr_tpu_torch.sfm import triangulate
    from lfr_tpu_torch.utils import synthetic

    root = os.path.join(tmp, "tri_full")
    t0 = time.perf_counter()
    truth = synthetic.triangulation_workload(np.random.default_rng(2), root, **TRI_SCENE)
    made_s = time.perf_counter() - t0
    ids, point_of = _tri_truth(root, truth)
    lines = {}
    for solution in (None, truth["solution_file"]):
        line, _ = _tri_run(root, truth, solution, ids, point_of)
        line["scene"] = {**TRI_SCENE, "made_s": made_s}
        lines[line["run"]] = line
        print(json.dumps({"triangulation": line}), flush=True)
    raw, ref = lines["raw"], lines["ref"]

    # Controls the gates must reject.
    db = colmap_db.ColmapDatabase(os.path.join(root, "sift-raw.db"))
    empty = colmap_model.read_model(os.path.join(root, "sparse-sift-raw-empty"))
    dlt = triangulate.triangulate_model(db, empty, iterations=0).model
    db.close()
    controls = {
        "raw_gn_0_steps_point_error_median": float(np.median(
            _point_errors(dlt, point_of, truth["points"]))),
        "putative_as_inliers_survive_share": _rewired_survival(
            os.path.join(root, "sift-raw.db"), ids, point_of, truth, "matches")[0],
    }
    for name, line in lines.items():
        if line["stats"]["num_reg_images"] != TRI_SCENE["num_cameras"]:
            raise RuntimeError(f"triangulation {name}: {line['stats']['num_reg_images']} "
                               "images registered")
        if not line["rewired_survive_share"] <= REWIRED_SURVIVE_SHARE:
            raise RuntimeError(f"triangulation {name}: {line['rewired_survive_share']} of the "
                               "rewired matches survive verification")
    if not (ref["stats"]["mean_reproj_error"] < raw["stats"]["mean_reproj_error"]
            and ref["point_error_median"] < raw["point_error_median"]):
        raise RuntimeError("triangulation: ref is not more accurate than raw")
    if not ref["point_error_median"] < POINT_ERROR_MEDIAN:
        raise RuntimeError(f"triangulation ref: median point error {ref['point_error_median']}")
    if controls["raw_gn_0_steps_point_error_median"] < POINT_ERROR_MEDIAN:
        raise RuntimeError(f"triangulation: the accuracy gate passes its control {controls}")
    if controls["putative_as_inliers_survive_share"] <= REWIRED_SURVIVE_SHARE:
        raise RuntimeError(f"triangulation: the outlier gate passes its control {controls}")

    # (b) card vs CPU, card vs card, on the small scene.
    small = os.path.join(tmp, "tri_small")
    truth = synthetic.triangulation_workload(np.random.default_rng(3), small, **TRI_SMALL_SCENE)
    roots = {k: os.path.join(tmp, f"tri_small_{k}") for k in ("card1", "card2", "cpu")}
    seconds = {}
    for name, path in roots.items():
        shutil.copytree(small, path)
        t0 = time.perf_counter()
        triangulation_pipeline(path, "sift", truth["matches_file"], truth["solution_file"],
                               verbose=False, device="cpu" if name == "cpu" else "cuda")
        seconds[name] = time.perf_counter() - t0
    compare = _compare_card_cpu(roots["card1"], roots["cpu"])
    compare["identical_bytes_second_card_run"] = (
        _geometry_bytes(roots["card1"]) == _geometry_bytes(roots["card2"]))
    compare.update(scene=TRI_SMALL_SCENE, seconds=seconds, controls=controls,
                   bounds={"point_error_median": POINT_ERROR_MEDIAN,
                           "rewired_survive_share": REWIRED_SURVIVE_SHARE})
    print(json.dumps({"triangulation_check": compare}), flush=True)
    if not compare["identical_bytes_second_card_run"]:
        raise RuntimeError("triangulation: a second card run wrote other bytes")
    return lines


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

    tmp = tempfile.mkdtemp(prefix="lfr_match_graph_")
    try:
        t0 = time.perf_counter()
        paths["match_graph"], matches_file = match_graph_phase(correlation, tmp)
        phase("match_graph", t0)

        t0 = time.perf_counter()
        solve_phase(matches_file, tmp)
        phase("solve", t0)

        t0 = time.perf_counter()
        correlation.reset_launches()
        triangulation_phase(tmp)
        paths["triangulation"] = dict(correlation.LAUNCHES)
        phase("triangulation", t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

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
