#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (lfr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its seconds; any failure ends the run non-zero:

1. device:  needs a CUDA device; prints the card's name and power limit and
   the TF32 and cuDNN settings (``cudnn.benchmark`` off, the library's
   default).
2. build:   nvcc builds each of lfr_tpu_torch/csrc/correlation.cu and
   nn_dist.cu for sm_90a into a library of its own under
   lfr_tpu_torch/_build/ (plain-C libraries loaded with ctypes), and g++
   builds the host library csrc/lfr_native.cc (the MatchingFile codec, the
   MSF, the counting argsort), the three compilers started together.  Every
   later phase decodes and encodes MatchingFiles and builds tracks through
   that host library (the port's default).
   jpeg:    the port's JPEG decoder on the seven fixture JPEGs; each decoded
   RGB array's SHA-256 must equal FIXTURE_SHA256 of
   tests/test_torch_jpeg.py (which holds them against cv2.imread); prints
   the host's decode rate in microseconds per Mpix.
3. kernels: each of the four correlation kernels on seeded inputs (asym,
   nonorm and matmul at B=4096, sym at B=2048), held against its plain
   PyTorch version; kernel, plain-version and one-PyTorch-call
   (``library_ms``) times from CUDA events, beside the least time the card
   could take (``bound_ms``); each kernel's line also carries the time of
   the previous kernel design, the WMMA kernel with f32 row staging that
   this one replaced (``ms_pr5``, a constant, NVIDIA H100 80GB HBM3 at
   700 W).  Then the nearest-neighbour kernel (nn_dist) against its plain
   version on seeded points in both shapes of the evaluation at a reduced
   size: squared distances within NN_ULPS, counts within each tolerance
   equal except queries within NN_ULPS of tol^2.
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
   synthetic.triangulation_workload.  First the scene's MatchingFile
   (519,033 putative matches) is decoded and encoded by the host C++ codec
   and by its plain numpy version, with each route's seconds: the arrays
   and names must be equal and both encodings the file's bytes (one
   ``{"native_codec": ...}`` line).  (a) The full-size scene (TRI_SCENE:
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
9. sfm: incremental SfM (lfr_tpu_torch.pipelines.benchmark.run_sfm: import
   and verification, then the mapper with PnP registration, triangulation
   and bundle adjustment; torch ops on the card, no kernel of ours).  (a)
   A copy of the triangulation phase's full scene without its outputs, with
   its MatchingFile and planted SolutionFile, ref then raw: one ``{"sfm":
   ...}`` line per run with the seconds, the mapper's phase_times,
   analyze_model's stats, the camera-centre errors after a similarity
   alignment to the planted poses, BA calls and LM steps, and peak memory;
   the raw run's last global BA run again alone under torch.profiler (busy
   share, launches per LM step).  Gates: every camera registered (SFM_REGISTERED) in ref and
   raw; the median and largest centre errors under CENTER_ERROR_MEDIAN and
   CENTER_ERROR_MAX, which the ref database reconstructed with BA off must
   fail; ref's mean reprojection error below raw's.  (b) The small scene,
   ref, twice on the card and once on the CPU (the same CPU-drawn
   samples): the same images registered in the same order, centres within
   SFM_CENTER_ATOL after alignment, point counts within SFM_POINT_SHARE, and
   the two card runs write the same model bytes.
10. benchmark_eth: ``benchmark eth`` (lfr_tpu_torch.pipelines.benchmark.run_eth)
   with weights/panet_holdout.msgpack, ref and raw with the evaluation, on
   synthetic.eth_workload: 30 rendered views of layered_scene at 1600x1067
   (an ETH3D DSLR image after the sift caps), 640 planted points with 1 px
   keypoint noise, exposure jitter 0.12, layered_surface_mesh() as the scan
   (about 27M surface samples).  One ``{"benchmark_eth": ...}`` line with
   every span of run_eth's timing, the match graph's matches/s, the
   evaluation split into scan sampling, visibility and nn, and accuracy,
   completeness and F1 per tolerance for ref and raw.  The nn_dist kernel
   at the scene's two sizes (accuracy: reconstruction against the scan;
   completeness: visible samples against the reconstruction) is held
   against its plain version on the same inputs (NN_ULPS; counts equal
   except ties) and timed beside the plain version, its instruction bound
   and chunked torch.cdist, each on the full inputs.  Gates: (a) the
   card's evaluation of the ref PLY against the host cKDTree route (f64):
   a query may lie on the other side of a tolerance only if its f64
   distance is within the f32 rounding margin of that tolerance
   (STRADDLE_ULPS); (b) the visibility mask on the card against the CPU on
   a reduced scan (VIS_SAMPLES): identical except samples within VIS_RTOL
   of a bin's depth limit; (c) ref's accuracy at 1 cm at least
   ETH_ACCURACY_MIN, which raw and the ref PLY shifted by CONTROL_SHIFT_M
   along z must fail.
11. extract: the user's path from images to the ETH3D numbers with the
   port's own features, on a copy of benchmark_eth's scene without its
   planted ``.sift`` files (the scan cache kept), with the library's TF32
   defaults (the extractors must compute in f32 whatever they say).  SIFT
   (lfr_tpu_torch.pipelines.extract_features, torch ops, no kernel of ours)
   on all 30 views, with images/s, keypoints per view and host ms per view
   by span; then the copy cut to its first EXTRACT_CAMERAS cameras,
   ``dataset create-db-eth`` and ``match-list``, and run_eth ref and raw
   (corr_sym, corr_asym and nn_dist launch: path "extract_eth").  One
   ``{"extract": ...}`` line.  This run's evaluation is checked as
   benchmark_eth's is: nn_dist at this path's shapes (the points
   triangulated from the extracted features; the samples visible from
   EXTRACT_CAMERAS cameras) against its plain version, and the fractions
   against the host cKDTree, in one ``{"extract_evaluation": ...}`` line.
   Then a traced extraction on STAGE_VIEWS views (busy share, launches and
   the kernel time of SIFT's device stages by profiler range), SIFT, DoH
   and SURF on one view card against CPU (MATCH_PX, DESC_ATOL) beside two
   CPU controls (PERTURB, and the other CPU convolution route), and the
   fixture JPEGs' host cost: one ``{"extract_check": ...}`` line.  Gates:
   every camera registered in ref and raw, each of the three kernels
   launched, nn_dist and the evaluation as above, SIFT's and DoH's
   card-vs-CPU shares at least the lesser control's less CONTROL_MARGIN,
   and SURF's at least SURF_MIN_SHARE with equal keypoint counts.
12. train: PANet training (lfr_tpu_torch.models.train; the unfolded model,
   train-mode correlation as plain torch ops under autograd, as the JAX
   package's training; its eval-mode forward launches corr_asym).  (a) One
   f32 Adam step (constant learning rate TRAIN_LR) from
   weights/panet_holdout.msgpack on a batch of TRAIN_CHECK_PAIRS from
   sample_batch_warped(np.random.default_rng(0), the fixture JPEGs), card
   against CPU: the loss, and the parameters and batch statistics as
   relative norms of their difference over the step's update, each within
   TRAIN_CONTROL_FACTOR times the larger of two CPU controls (the CPU step
   on inputs scaled by 1 + PERTURB N(0, 1), and the CPU step with oneDNN
   off); one ``{"train_check": ...}`` line.  (b) train(num_steps=TRAIN_STEPS,
   batch_size=TRAIN_BATCH, corpus="synthetic", seed=0) in bf16 (the CLI's
   defaults but the step count), then the same at learning rate 0 as the
   control: steps/s, patch pairs/s, host sampling and step seconds per
   step, peak memory; the mean loss of the last 16 steps must lie below the
   first 16's by TRAIN_LOSS_DROP, which the control must fail; one traced
   chunk of 16 steps gives the kernel ms, launches and busy share per step.
   (c) evaluate_px_error on 256 warped fixture pairs before and after
   training (corr_asym launches), save_variables -> load_variables equal
   bit for bit, and the trained checkpoint folded into TwoViewRefiner on
   bench.py's pair with finite flows.  Launches count for the path "train".
13. variants: scripts/bench_corr_variants_torch.py's run (asym, nonorm and
   matmul kernels and two PyTorch calls at B=4096).
14. the kernel list as one JSON line, the card's name and power limit, and
   the result line ``{"ok": true, "device": {...}}`` last.

Each path's kernel launches are counted from 0 just before it runs and read
just after; every kernel must be launched on at least one path.

Imports torch, numpy, scipy and lfr_tpu_torch only.
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

#: The sfm phase: every camera of each scene registers in ref and raw, as
#: JAX's mapper registers 30 of 30 (TRI_SCENE) and 8 of 8 (TRI_SMALL_SCENE)
#: of these scenes on the CPU, and the port on the CPU too.
SFM_REGISTERED = {"full": TRI_SCENE["num_cameras"], "small": TRI_SMALL_SCENE["num_cameras"]}

#: Camera centres after a similarity alignment to the planted poses, in
#: scene units (the cameras lie on an arc of radius 6, 0.054 apart): median
#: and largest error.  The bounds lie between the card's readings (ref
#: 6.7e-5 / 4.8e-4, raw 2.9e-4 / 1.15e-3; NVIDIA H100 80GB HBM3 at 700 W,
#: PERF.md) and those of the control that must fail them, the ref database
#: reconstructed with bundle adjustment off (MapperOptions ba_iterations =
#: ba_local_iterations = 0: 1.37e-2 / 2.92e-2).
CENTER_ERROR_MEDIAN = 2e-3
CENTER_ERROR_MAX = 6e-3

#: Card vs CPU on the small scene (ref): camera centres after a similarity
#: alignment of the card's to the CPU's within SFM_CENTER_ATOL, point counts
#: within SFM_POINT_SHARE.  The control, the CPU against itself on keypoints
#: scaled by 1 + 2e-7 N(0, 1) (3 seeds), read 3.9e-6 to 5.5e-6 and equal
#: counts; the bound is 4 times its largest reading, as the parity tests
#: bound the port against JAX (the card rounds otherwise at every step; it
#: read 2.6e-6, NVIDIA H100 80GB HBM3 at 700 W; PERF.md).  A point's gate
#: can flip at a near-tie (at most 1e-3 of the points in the triangulation
#: phase), hence the count's share.
SFM_CENTER_ATOL = 2.2e-5
SFM_POINT_SHARE = 5e-3

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

#: nn_dist against its plain version: the kernel's fused multiply-adds
#: against the plain version's f64-formed ones may differ by one rounding
#: where the f64 sum lands on an f32 midpoint (about one in 2^29).
NN_ULPS = 2

#: The nn_dist check's shapes: (queries, corpus) of the accuracy and the
#: completeness direction at a reduced size.
NN_CHECK_SHAPES = ((4096, 1_000_003), (1_000_003, 700))

#: H100 SXM FP32 lanes per SM (instruction issue: 4 schedulers x 32) and the
#: FP32 instructions of one query-corpus pair (3 subtractions, a product, 2
#: fused multiply-adds, a minimum).
FP32_LANES_PER_SM = 128
NN_INSTRUCTIONS_PER_PAIR = 7

#: Card (f32) against the host cKDTree (f64): a query may fall on the other
#: side of a tolerance t only if its f64 distance lies within
#: sqrt(3) * spacing_f32(largest |coordinate|) (each coordinate is rounded to
#: f32 on upload) + STRADDLE_ULPS * spacing_f32(t) (the f32 differences,
#: fused sums and tol^2 round a few times, each by at most an ulp of t) of t.
STRADDLE_ULPS = 8

#: The benchmark_eth phase's scene seed.
ETH_SEED = 4

#: Accuracy gate: ref's accuracy at 1 cm must be at least ETH_ACCURACY_MIN;
#: raw (no refinement) and the ref PLY shifted by CONTROL_SHIFT_M along z
#: (the scene's surfaces are planes of constant z) must fail it.  The bound
#: lies between the card's readings (PERF.md): ref 0.857-0.860, raw
#: 0.715-0.739, shifted 0.066-0.076.
ETH_ACCURACY_MIN = 0.8
CONTROL_SHIFT_M = 0.02

#: Visibility gate: card against CPU on every k-th scan sample, k chosen
#: for about VIS_SAMPLES samples; a sample may differ only within VIS_RTOL
#: of its bin's depth limit in some view.
VIS_SAMPLES = 500_000
VIS_RTOL = 1e-6

#: The extract phase: SIFT on every view of the benchmark_eth scene, then
#: run_eth from the extracted features on its first EXTRACT_CAMERAS cameras
#: (66 pairs; a cut that keeps the script near 480 s).
EXTRACT_CAMERAS = 12

#: Card against CPU for each extractor on one full-size view: the share of
#: keypoints with one of the other run's within MATCH_PX pixels, and of
#: those pairs whose descriptors agree within DESC_ATOL in every component
#: (about 2 levels of the x512 uint8 code).
MATCH_PX = 1e-2
DESC_ATOL = 4e-3

#: The controls that set each bound, both on the CPU: (1) the view against
#: the view with each pixel scaled by 1 + PERTURB * N(0, 1) (a change of an
#: ulp or two); (2) the view with oneDNN's convolution against the view with
#: PyTorch's own (the blur rounded in another order, as the card's cuDNN
#: rounds it: on tests/fixtures' DSC_0001 the DoH keypoints of the two CPU
#: routes agree at 93%, against 96% for the perturbation).  The card may fall
#: CONTROL_MARGIN below the lesser of the two (SIFT and DoH; SURF has its
#: own gate, SURF_MIN_SHARE).  The card read 100% / 100% (SIFT), 99.8% /
#: 99.97% (DoH) and 100% / 100% (SURF) of keypoints / descriptors against
#: bounds of 97.9 / 97.7 and 94.5 / 97.8% (NVIDIA H100 80GB HBM3, 700 W;
#: PERF.md).
PERTURB = 2e-7
CONTROL_MARGIN = 0.02

#: SURF card against CPU: equal keypoint counts, and at least
#: SURF_MIN_SHARE of keypoints matched and of descriptors agreeing.  Its
#: response maps are the same on any device (the integral image in one
#: fixed order of f32 additions, box sums and the determinant one rounded
#: operation at a time) and its non-max suppression is the same host numpy,
#: so the keypoints are the same set; only atan2, sin and cos may round
#: differently on the card, which can move a Haar sample that snaps to an
#: integer pixel in a few keypoints.  The perturbation control (80.5% /
#: 55.1% less the margin) would let half the descriptors go wrong.
SURF_MIN_SHARE = 0.99

#: Views of the traced extraction (SIFT's device stages by profiler range).
STAGE_VIEWS = 5

#: Steps of the failed-Cholesky check.
LM_CHECK_ITER = 4

#: The train phase.  (a) the card-vs-CPU step: batch, learning rate, and
#: the factor on the larger CPU control.  Why two controls: the card's
#: cuDNN convolutions sum in another order than the CPU's oneDNN, and Adam's
#: first step moves each parameter by about lr times the sign of its
#: gradient, so entries with rounding-level gradients flip; the input
#: perturbation alone does not reach that (the CPU tests read the port
#: against JAX at 1.0-2.3 times the oneDNN-off control and 4-25 times the
#: perturbation control).
TRAIN_CHECK_PAIRS = 16
TRAIN_LR = 1e-3
TRAIN_CONTROL_FACTOR = 4.0
#: (b) the training run (the CLI's defaults but the step count) and its
#: gate: the mean loss of the first 16 steps over that of the last 16.  The
#: same runs on the CPU (scripts/train_torch_loss_drop.py, PERF.md) read
#: 82.3 at TRAIN_LR and 0.975 at learning rate 0.  The bound is a quarter
#: of the CPU's 82.3: the card's bf16 run (cuDNN's backward sums in another
#: order, not deterministically) may end at up to 4 times the CPU's last
#: losses and pass, while a run that does not learn reads about 1 and fails.
TRAIN_STEPS = 256
TRAIN_BATCH = 64
TRAIN_LOSS_DROP = 20.0
#: (c) pairs of the validation batch (two eval chunks of 128).
TRAIN_EVAL_PAIRS = 256

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


def reset_launches():
    """Set every kernel's launch count to 0."""
    from lfr_tpu_torch.ops import correlation, nn_dist

    correlation.reset_launches()
    nn_dist.reset_launches()


def read_launches():
    """Every kernel's launch count since the last reset_launches()."""
    from lfr_tpu_torch.ops import correlation, nn_dist

    return {**correlation.LAUNCHES, **nn_dist.LAUNCHES}


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


def slice_phase():
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

    launches = {key: 0 for key in read_launches()}
    results = {}
    for mode in ("crop", "grid"):
        t0 = time.perf_counter()
        refiner = TwoViewRefiner(variables, batch_size=BATCH, fine_mode=mode, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        refiner.refine_matches(prep1, kps1, prep2, kps2, matches)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        handles = [
            refiner.refine_matches_async(prep1, kps1, prep2, kps2, matches) for _ in range(REPS)
        ]
        outs = [refiner.resolve_refined(h) for h in handles]
        dt = (time.perf_counter() - t1) / REPS
        counts = read_launches()
        calls = REPS + 1
        want = {"corr_sym": calls * chunks, "corr_asym": 9 * calls * chunks,
                "corr_nonorm": 0, "corr_matmul": 0, "nn_dist": 0}
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


def match_graph_phase(tmp):
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
    reset_launches()
    t0 = time.perf_counter()
    written = compute_match_graph(tmp, scene["match_list"], method, output,
                                  refiner=refiner, sub_spans=spans, progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30

    batches = spans["refine_dispatch"]["calls"]
    want = {"corr_sym": batches, "corr_asym": 9 * batches, "corr_nonorm": 0,
            "corr_matmul": 0, "nn_dist": 0}
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


def native_codec_check(matches_file):
    """The MatchingFile codec's two routes on one file: decode and encode
    seconds of the host C++ codec and of its plain numpy version; the
    decoded arrays and names must be equal and both encodings the file."""
    from lfr_tpu_torch.io import protos

    with open(matches_file, "rb") as fh:
        data = fh.read()
    seconds, pairs, blobs = {}, {}, {}
    for route, native in (("native", True), ("numpy", False)):
        t0 = time.perf_counter()
        pairs[route] = protos.decode_matching_file(data, use_native=native)
        seconds[f"decode_{route}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        blobs[route] = protos.encode_matching_file(pairs[route], use_native=native)
        seconds[f"encode_{route}_s"] = time.perf_counter() - t0
    equal = len(pairs["native"]) == len(pairs["numpy"]) and all(
        (a.image_name1, a.fact1, a.image_name2, a.fact2)
        == (b.image_name1, b.fact1, b.image_name2, b.fact2)
        and all(getattr(a, f).dtype == getattr(b, f).dtype
                and getattr(a, f).tobytes() == getattr(b, f).tobytes()
                for f in ("matches", "similarities", "disp1", "disp2"))
        for a, b in zip(pairs["native"], pairs["numpy"]))
    line = {"pairs": len(pairs["native"]),
            "matches": sum(p.num_matches for p in pairs["native"]), "bytes": len(data),
            **seconds, "decode_speedup": seconds["decode_numpy_s"] / seconds["decode_native_s"],
            "decoded_equal": equal,
            "encoded_equal": blobs["native"] == blobs["numpy"] == data}
    print(json.dumps({"native_codec": line}), flush=True)
    if not (line["decoded_equal"] and line["encoded_equal"]):
        raise RuntimeError(f"native codec differs from its numpy version: {line}")


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
    native_codec_check(truth["matches_file"])
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


def _camera_centres(model):
    from lfr_tpu_torch.io import colmap_model

    return {im.name: -colmap_model.qvec_to_rotmat(im.qvec).T @ im.tvec
            for im in model.images.values()}


def _aligned_errors(est, ref):
    """Distances of the centres ``est`` (name -> (3,)) from ``ref`` after
    the least-squares similarity that maps them onto ``ref`` (Umeyama)."""
    names = sorted(est.keys() & ref.keys())
    A = np.array([est[n] for n in names])
    B = np.array([ref[n] for n in names])
    a, b = A - A.mean(0), B - B.mean(0)
    U, S, Vt = np.linalg.svd(b.T @ a)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    scale = np.trace(np.diag(S) @ D) / (a**2).sum()
    return np.linalg.norm(scale * a @ R.T + B.mean(0) - B, axis=1)


class _SfmMeter:
    """Counts the mapper's BA calls and LM steps per run (local / global),
    the run's seconds and peak memory, and keeps each run's last global BA
    problem for :meth:`trace`.  It wraps ba.run_ba, the mapper's _run_ba
    and the benchmark module's reconstruction_pipeline while installed."""

    def __init__(self):
        self.runs = {}
        self.last_global = {}

    def __enter__(self):
        import torch

        from lfr_tpu_torch.pipelines import benchmark
        from lfr_tpu_torch.sfm import ba, mapper

        self._saved = (ba.run_ba, mapper.IncrementalMapper._run_ba,
                       benchmark.rec_pipeline.reconstruction_pipeline)
        run_ba, mapper_run_ba, pipeline = self._saved
        state = {"kind": None, "counts": None, "tag": None}

        def counted_run_ba(problem, **kw):
            stats = {}
            out = run_ba(problem, stats=stats, **kw)
            c = state["counts"][state["kind"]]
            c["calls"] += 1
            c["lm_iterations"] += stats["iterations"]
            c["lm_steps"] += stats["steps"]
            if state["kind"] == "global":
                self.last_global[state["tag"]] = (problem, kw, stats["steps"])
            return out

        def kind_run_ba(mapper_self, local_around=None, final=False):
            state["kind"] = "global" if local_around is None else "local"
            return mapper_run_ba(mapper_self, local_around, final)

        def metered_pipeline(dataset_path, method_name, matches_file, solution_file=None,
                             *args, **kw):
            tag = "raw" if solution_file is None else "ref"
            state["tag"] = tag
            state["counts"] = {k: {"calls": 0, "lm_iterations": 0, "lm_steps": 0}
                               for k in ("local", "global")}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = pipeline(dataset_path, method_name, matches_file, solution_file, *args, **kw)
            torch.cuda.synchronize()
            self.runs[tag] = {"seconds": time.perf_counter() - t0, "ba": state["counts"],
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
            return out

        ba.run_ba = counted_run_ba
        mapper.IncrementalMapper._run_ba = kind_run_ba
        benchmark.rec_pipeline.reconstruction_pipeline = metered_pipeline
        return self

    def __exit__(self, *exc):
        from lfr_tpu_torch.pipelines import benchmark
        from lfr_tpu_torch.sfm import ba, mapper

        (ba.run_ba, mapper.IncrementalMapper._run_ba,
         benchmark.rec_pipeline.reconstruction_pipeline) = self._saved

    def trace(self, tag):
        """The run's last global BA, run again alone under torch.profiler
        (after a warm-up call): wall and kernel time, the device's busy
        share, launches per LM step and the costliest kernels."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from lfr_tpu_torch.sfm import ba

        problem, kw, steps = self.last_global[tag]
        ba.run_ba(problem, **kw)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ba.run_ba(problem, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        cuda = torch.autograd.DeviceType.CUDA
        by_name = {}
        for evt in prof.events():
            if evt.device_type == cuda and not evt.is_user_annotation:
                count, ms = by_name.get(evt.name, (0, 0.0))
                by_name[evt.name] = count + 1, ms + evt.time_range.elapsed_us() / 1e3
        kernel_ms = sum(ms for _, ms in by_name.values())
        launches = sum(c for k, (c, _) in by_name.items() if "memcpy" not in k.lower())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
        return {"wall_s": wall, "kernel_ms": kernel_ms,
                "device_busy_share": kernel_ms / (wall * 1e3), "lm_steps": steps,
                "launches": launches, "launches_per_lm_step": launches / max(steps, 1),
                "ms_per_lm_step": wall * 1e3 / max(steps, 1),
                "top_kernels": [{"name": k[:80], "count": c, "ms": ms} for k, (c, ms) in top[:6]]}


def _model_bytes(root, tag):
    out = []
    for name in ("images.txt", "points3D.txt"):
        with open(os.path.join(root, f"sparse-sift-{tag}", name), "rb") as fh:
            out.append(fh.read())
    return out


def sfm_phase(tmp):
    """Incremental SfM on the card: (a) the full scene, ref and raw, with
    the gates and their control; (b) card vs CPU and card vs card on the
    small scene.  Reuses the triangulation phase's pristine scenes."""
    from lfr_tpu_torch.io import colmap_db, colmap_model
    from lfr_tpu_torch.pipelines import benchmark, reconstruction
    from lfr_tpu_torch.sfm import mapper

    root = os.path.join(tmp, "sfm_full")
    shutil.copytree(os.path.join(tmp, "tri_full"), root,
                    ignore=shutil.ignore_patterns("sift-*.db", "sparse-*"))
    truth = colmap_model.read_model(os.path.join(root, "dslr_calibration_undistorted"))
    truth = _camera_centres(truth)
    out = os.path.join(tmp, "sfm_out")
    t0 = time.perf_counter()
    with _SfmMeter() as meter:
        results = benchmark.run_sfm(root, "sift", output_path=out,
                                    matches_file=os.path.join(root, "matches.pb"),
                                    solution_file=os.path.join(root, "solution.pb"),
                                    verbose=False)
    seconds = time.perf_counter() - t0
    lines = {}
    for tag in ("ref", "raw"):
        rec = dict(results[tag]["reconstruction"])
        model = colmap_model.read_model(os.path.join(root, f"sparse-sift-{tag}"))
        errors = _aligned_errors(_camera_centres(model), truth)
        line = {"run": tag, **meter.runs[tag], "phase_times": rec.pop("phase_times"),
                "stats": rec, "matching": results[tag]["matching"],
                "center_error_median": float(np.median(errors)),
                "center_error_max": float(errors.max()), "scene": TRI_SCENE}
        if tag == "raw":
            line["last_global_ba_traced"] = meter.trace(tag)
        lines[tag] = line
        print(json.dumps({"sfm": line}), flush=True)

    # The control: the ref database reconstructed with bundle adjustment off.
    control_db = os.path.join(tmp, "sfm_control.db")
    shutil.copyfile(os.path.join(root, "sift-ref.db"), control_db)
    db = colmap_db.ColmapDatabase(control_db)
    t0 = time.perf_counter()
    model, stats = mapper.reconstruct(
        db, mapper.MapperOptions(ba_iterations=0, ba_local_iterations=0), verbose=False)
    db.close()
    errors = _aligned_errors(_camera_centres(model), truth)
    control = {"ba_off_registered": stats["num_reg_images"],
               "ba_off_center_error_median": float(np.median(errors)),
               "ba_off_center_error_max": float(errors.max()),
               "ba_off_mean_reproj_error": stats["mean_reproj_error"],
               "seconds": time.perf_counter() - t0}
    for tag, line in lines.items():
        if line["stats"]["num_reg_images"] != SFM_REGISTERED["full"]:
            raise RuntimeError(f"sfm {tag}: {line['stats']['num_reg_images']} images registered")
        if not (line["center_error_median"] < CENTER_ERROR_MEDIAN
                and line["center_error_max"] < CENTER_ERROR_MAX):
            raise RuntimeError(f"sfm {tag}: camera centres off by {line['center_error_median']}"
                               f" (median), {line['center_error_max']} (max)")
    if (control["ba_off_center_error_median"] < CENTER_ERROR_MEDIAN
            or control["ba_off_center_error_max"] < CENTER_ERROR_MAX):
        raise RuntimeError(f"sfm: the camera-centre gate passes its control {control}")
    if not lines["ref"]["stats"]["mean_reproj_error"] < lines["raw"]["stats"]["mean_reproj_error"]:
        raise RuntimeError("sfm: ref's mean reprojection error is not below raw's")

    # (b) card vs CPU, card vs card, on the small scene.
    small = os.path.join(tmp, "tri_small")
    roots = {k: os.path.join(tmp, f"sfm_small_{k}") for k in ("card1", "card2", "cpu")}
    small_seconds, models = {}, {}
    for name, path in roots.items():
        shutil.copytree(small, path, ignore=shutil.ignore_patterns("sift-*.db", "sparse-*"))
        t0 = time.perf_counter()
        reconstruction.reconstruction_pipeline(
            path, "sift", os.path.join(path, "matches.pb"), os.path.join(path, "solution.pb"),
            verbose=False, device="cpu" if name == "cpu" else "cuda")
        small_seconds[name] = time.perf_counter() - t0
        models[name] = colmap_model.read_model(os.path.join(path, "sparse-sift-ref"))
    order = {k: [im.name for im in m.images.values()] for k, m in models.items()}
    deviation = _aligned_errors(_camera_centres(models["card1"]), _camera_centres(models["cpu"]))
    counts = {k: len(m.points3D) for k, m in models.items()}
    check = {"scene": TRI_SMALL_SCENE, "seconds": small_seconds, "registered": order["card1"],
             "same_order_as_cpu": order["card1"] == order["cpu"],
             "center_deviation_max": float(deviation.max()), "points": counts,
             "identical_bytes_second_card_run": (_model_bytes(roots["card1"], "ref")
                                                 == _model_bytes(roots["card2"], "ref")),
             "control": control, "seconds_full_phase_runs": seconds,
             "bounds": {"center_error_median": CENTER_ERROR_MEDIAN,
                        "center_error_max": CENTER_ERROR_MAX,
                        "center_atol": SFM_CENTER_ATOL, "point_share": SFM_POINT_SHARE}}
    print(json.dumps({"sfm_check": check}), flush=True)
    if len(order["card1"]) != SFM_REGISTERED["small"]:
        raise RuntimeError(f"sfm small: {len(order['card1'])} images registered")
    if not check["same_order_as_cpu"]:
        raise RuntimeError(f"sfm small: registration order {order['card1']} on the card, "
                           f"{order['cpu']} on the CPU")
    if not check["center_deviation_max"] <= SFM_CENTER_ATOL:
        raise RuntimeError(f"sfm small: card and CPU centres differ by {deviation.max()}")
    if not abs(counts["card1"] - counts["cpu"]) <= SFM_POINT_SHARE * counts["cpu"]:
        raise RuntimeError(f"sfm small: {counts} points")
    if not check["identical_bytes_second_card_run"]:
        raise RuntimeError("sfm small: a second card run wrote other bytes")
    return lines


def _fixture_sha256():
    """FIXTURE_SHA256 of tests/test_torch_jpeg.py, read without importing the
    test (it imports cv2 and jax, which the card's machine lacks)."""
    import ast

    with open(os.path.join(HERE, "tests", "test_torch_jpeg.py")) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "FIXTURE_SHA256" for t in node.targets):
            return ast.literal_eval(node.value)
    raise RuntimeError("tests/test_torch_jpeg.py has no FIXTURE_SHA256")


def jpeg_phase():
    """The port's JPEG decoder on the fixture JPEGs, against the SHA-256 of
    cv2.imread's arrays; the host decode rate."""
    import hashlib

    from lfr_tpu_torch.io.images import load_image_rgb

    want = _fixture_sha256()
    seconds, pixels = 0.0, 0
    for rel, sha in sorted(want.items()):
        t0 = time.perf_counter()
        image = load_image_rgb(os.path.join(HERE, "tests", "fixtures", rel))
        seconds += time.perf_counter() - t0
        pixels += image.shape[0] * image.shape[1]
        got = hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest()
        if got != sha:
            raise RuntimeError(f"jpeg: {rel} decodes to SHA-256 {got}, cv2.imread's is {sha}")
    line = {"images": len(want), "sha256_equal": len(want), "decode_s": seconds,
            "megapixels": pixels / 1e6, "us_per_mpix": seconds * 1e6 / (pixels / 1e6),
            "where": "host CPU of the card's machine, Python Huffman stage"}
    print(json.dumps({"jpeg": line}), flush=True)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.maximum(a, b))


def _near_tol2(d2, tol2):
    return int((np.abs(np.asarray(d2, np.float64) - tol2) <= NN_ULPS * np.spacing(tol2)).sum())


def nn_kernel_check(nn_dist):
    """nn_dist against its plain version on the card at NN_CHECK_SHAPES;
    returns the largest |kernel - plain| of the squared distances."""
    import torch

    from lfr_tpu_torch.config import ETH3D_TOLERANCES

    tol2 = np.square(np.asarray(ETH3D_TOLERANCES, np.float32))
    rng = np.random.default_rng(5)
    worst = 0.0
    for nq, nc in NN_CHECK_SHAPES:
        corpus = rng.uniform((-1, -1, 5.5), (1, 1, 6.5), (nc, 3)).astype(np.float32)
        queries = rng.uniform((-1.2, -1.2, 5.3), (1.2, 1.2, 6.7), (nq, 3)).astype(np.float32)
        q, c = torch.from_numpy(queries).cuda(), torch.from_numpy(corpus).cuda()
        got = nn_dist.nn_min_sq(q, c)
        torch.cuda.synchronize()
        want = nn_dist.min_sq_reference(q, c).cpu().numpy()
        got = got.cpu().numpy()
        ulps = float(_ulps(got, want).max())
        err = float(np.abs(got - want).max())
        counts = nn_dist.count_within(q, c, ETH3D_TOLERANCES)
        for n, t2 in zip(counts, tol2):
            if abs(int(n) - int((want <= t2).sum())) > _near_tol2(want, t2):
                raise RuntimeError(f"nn_dist {nq}x{nc}: count within {t2} differs beyond ties")
        line = {"queries": nq, "corpus": nc, "max_ulps": ulps, "max_abs_err": err,
                "qpt_chunk": nn_dist.launch_plan(
                    nq, nc, torch.cuda.get_device_properties(0).multi_processor_count)}
        print(json.dumps({"nn_dist_check": line}), flush=True)
        if not ulps <= NN_ULPS:
            raise RuntimeError(f"nn_dist {nq}x{nc}: {ulps} ulps from the plain version")
        worst = max(worst, err)
        del q, c
    return worst


def _max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _library_min(q, c, chunk=2**20):
    """torch.cdist without the matmul identity, chunked over the larger side,
    then the minimum over the corpus: the yardstick, never the port's."""
    import torch

    if q.shape[0] >= c.shape[0]:
        return torch.cat([torch.cdist(q[i:i + chunk], c, compute_mode="donot_use_mm_for_euclid_dist")
                          .amin(1) for i in range(0, q.shape[0], chunk)])
    best = None
    for j in range(0, c.shape[0], chunk):
        d = torch.cdist(q, c[j:j + chunk], compute_mode="donot_use_mm_for_euclid_dist").amin(1)
        best = d if best is None else torch.minimum(best, d)
    return best


def _timed_once(fn):
    """(ms, result) of one call of fn(), from CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def nn_full_size(nn_dist, rec, scan, visible, library=True):
    """The kernel at the scene's two sizes (accuracy: the reconstruction
    against the scan; completeness: the visible samples against the
    reconstruction), held against its plain version on the same inputs
    (NN_ULPS; counts within each tolerance equal except queries within
    NN_ULPS of tol^2), with its time, the plain version's, its bound and,
    if ``library``, torch.cdist's on the full inputs.  Returns the numbers
    and the kernel's squared distances of each direction."""
    import torch

    from lfr_tpu_torch.config import ETH3D_TOLERANCES

    tol2 = np.square(np.asarray(ETH3D_TOLERANCES, np.float32))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_per_s = sms * FP32_LANES_PER_SM * _max_sm_clock_hz()
    acc_q = torch.from_numpy(np.ascontiguousarray(rec, np.float32)).cuda()
    directions = {
        "accuracy": (acc_q, torch.from_numpy(np.ascontiguousarray(scan, np.float32)).cuda()),
        "completeness": (torch.from_numpy(np.ascontiguousarray(visible, np.float32)).cuda(), acc_q),
    }
    out, d2 = {"issue_rate_per_s": issue_per_s}, {}
    for name in ("accuracy", "completeness"):
        q, c = directions.pop(name)
        pairs = q.shape[0] * c.shape[0]
        ops_ms = pairs * NN_INSTRUCTIONS_PER_PAIR / issue_per_s * 1e3
        bytes_ms = ((q.shape[0] + c.shape[0]) * 12 + q.shape[0] * 4) / HBM_BYTES_PER_S * 1e3
        ms = time_ms(lambda: nn_dist.nn_min_sq(q, c), runs=10, warmup=2)
        got = nn_dist.nn_min_sq(q, c).cpu().numpy()
        plain_ms, want = _timed_once(lambda: nn_dist.min_sq_reference(q, c))
        want = want.cpu().numpy()
        library_ms = None
        if library:
            _library_min(q[:8], c[:4096])  # warm-up
            library_ms, _ = _timed_once(lambda: _library_min(q, c))
        ulps = float(_ulps(got, want).max())
        differ = [abs(int((got <= t2).sum()) - int((want <= t2).sum())) for t2 in tol2]
        ties = [_near_tol2(want, t2) for t2 in tol2]
        out[name] = {
            "queries": q.shape[0], "corpus": c.shape[0], "pairs": pairs,
            "qpt_chunk": nn_dist.launch_plan(q.shape[0], c.shape[0], sms),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "max_ulps": ulps, "max_abs_err": float(np.abs(got - want).max()),
            "count_differ": differ, "ties": ties,
        }
        if not ulps <= NN_ULPS:
            raise RuntimeError(f"nn_dist {name}: {ulps} ulps from the plain version")
        if any(d > t for d, t in zip(differ, ties)):
            raise RuntimeError(f"nn_dist {name}: counts differ from the plain version "
                               f"{differ} beyond ties {ties}")
        d2[name] = got
        del q, c
    return out, d2


def _straddle_margin(scale, t):
    """How far from a tolerance t the f64 distance of a query may lie and
    still fall on the other side of t on the card (STRADDLE_ULPS)."""
    return float(np.sqrt(3.0) * np.spacing(np.float32(scale))
                 + STRADDLE_ULPS * np.spacing(np.float32(t)))


def _kdtree_check(label, card_ev, d2, rec, scan, visible):
    """The card's evaluation of ``rec`` (``card_ev``, from run_eth) against
    the host cKDTree route (f64): its fractions must be the nn_dist
    kernel's counts (``d2``: the kernel's squared distances of each
    direction), and a query may lie on the other side of a tolerance from
    the CPU's only if its f64 distance is within _straddle_margin of it."""
    from scipy.spatial import cKDTree

    from lfr_tpu_torch.config import ETH3D_TOLERANCES

    tols = list(ETH3D_TOLERANCES)
    t0 = time.perf_counter()
    d64 = {"accuracy": cKDTree(scan).query(rec, k=1, workers=-1)[0],
           "completeness": cKDTree(rec).query(visible, k=1, workers=-1)[0]}
    cpu_s = time.perf_counter() - t0
    tol2 = np.square(np.asarray(tols, np.float32))
    check = {"cpu_kdtree_s": cpu_s, "scan_samples": int(scan.shape[0]),
             "visible_samples": int(visible.shape[0]), "points": int(rec.shape[0])}
    for key, name, queries, corpus in (("accuracies", "accuracy", rec, scan),
                                       ("completenesses", "completeness", visible, rec)):
        n = queries.shape[0]
        card_counts = [int((d2[name] <= t2).sum()) for t2 in tol2]
        if card_ev[key] != [k / n for k in card_counts]:
            raise RuntimeError(f"{label}: {key} {card_ev[key]} are not the kernel's counts")
        scale = max(float(np.abs(queries).max()), float(np.abs(corpus).max()))
        sides, near, far = [], [], []
        for t2, t in zip(tol2, tols):
            flip = (d2[name] <= t2) != (d64[name] <= t)
            close = np.abs(d64[name] - t) <= _straddle_margin(scale, t)
            sides.append(int(flip.sum()))
            near.append(int(close.sum()))
            far.append(int((flip & ~close).sum()))
        check[key] = {"card": card_ev[key], "cpu": [float((d64[name] <= t).mean()) for t in tols],
                      "other_side": sides, "near_tolerance": near,
                      "margins_m": [_straddle_margin(scale, t) for t in tols]}
        if any(far):
            raise RuntimeError(f"{label}: {key}: {far} queries on the other side of a "
                               f"tolerance from the CPU's, beyond the margin")
    return check


def _depth_margins(points, model, idx):
    """For the samples ``idx`` of ``points``: the smallest relative distance,
    over the views in which each lands in frame, of its depth from its bin's
    depth limit (1.02 x the bin's nearest splatted depth), in f64 on the
    host."""
    from lfr_tpu_torch.io.colmap_model import qvec_to_rotmat
    from lfr_tpu_torch.sfm.cameras import calibration_matrix

    pts = points.astype(np.float64)
    images = sorted(model.images.values(), key=lambda im: im.image_id)
    grid_w = int(np.ceil(max(model.cameras[im.camera_id].width for im in images) / 8))
    margin = np.full(len(idx), np.inf)
    for im in images:
        cam = model.cameras[im.camera_id]
        K = calibration_matrix(cam)
        c = pts @ qvec_to_rotmat(im.qvec).T + im.tvec
        z = c[:, 2]
        front = z > 1e-9
        zs = np.where(front, z, 1.0)
        gx = np.floor((K[0, 0] * c[:, 0] / zs + K[0, 2]) / 8)
        gy = np.floor((K[1, 1] * c[:, 1] / zs + K[1, 2]) / 8)
        inb = front & (gx >= 0) & (gy >= 0) & (gx < np.ceil(cam.width / 8)) & (
            gy < np.ceil(cam.height / 8))
        bins = np.where(inb, gy * grid_w + gx, -1).astype(np.int64)
        depth = np.full(int(bins.max()) + 2, np.inf)
        sub = np.arange(0, len(pts), 4)
        keep = sub[inb[sub]]
        np.minimum.at(depth, bins[keep], z[keep])
        limit = depth[bins[idx]] * 1.02 + 1e-9
        rel = np.where(inb[idx], np.abs(z[idx] - limit) / limit, np.inf)
        margin = np.minimum(margin, rel)
    return margin


def benchmark_eth_phase(nn_dist, tmp):
    """run_eth on the card's scene; the nn_dist kernel against its plain
    version at the scene's sizes, with its numbers; the evaluation gates and
    their controls.  Returns (the path's launch counts, the nn_dist kernel
    row)."""
    import torch

    from lfr_tpu_torch.config import ETH3D_TOLERANCES
    from lfr_tpu_torch.eval import eth3d
    from lfr_tpu_torch.io.colmap_model import read_model, read_ply_xyz
    from lfr_tpu_torch.pipelines.benchmark import run_eth
    from lfr_tpu_torch.utils import synthetic

    root = os.path.join(tmp, "eth_scene")
    t0 = time.perf_counter()
    synthetic.eth_workload(np.random.default_rng(ETH_SEED), root)
    made_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    results = run_eth(root, "sift", output_path=os.path.join(tmp, "eth_out"),
                      checkpoint=os.path.join(HERE, "weights", "panet_holdout.msgpack"),
                      verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    if counts["nn_dist"] == 0 or counts["corr_sym"] == 0 or counts["corr_asym"] == 0:
        raise RuntimeError(f"benchmark_eth: kernel launches {counts}")

    spans = {s["span"]: s["ms"] / 1e3 for s in results["timing"]}
    mg = results["match_graph_breakdown"]
    tols = list(ETH3D_TOLERANCES)
    line = {
        "scene": {**synthetic.ETH_SCENE, "seed": ETH_SEED, "made_s": made_s},
        "seconds": seconds,
        "spans_s": spans,
        "refined_matches": mg["n_refined_matches"],
        "match_graph_matches_per_s": mg["n_refined_matches"] / spans["match_graph"],
        "match_graph_breakdown": mg,
        "launches": counts,
    }
    for tag in ("ref", "raw"):
        ev = results[tag]["evaluation"]
        line[tag] = {"points": results[tag]["triangulation"]["num_sparse_points"],
                     "registered": results[tag]["triangulation"]["num_reg_images"],
                     "mean_reproj_error": results[tag]["triangulation"]["mean_reproj_error"],
                     "tolerances": tols, "accuracies": ev["accuracies"],
                     "completenesses": ev["completenesses"], "f1_scores": ev["f1_scores"],
                     "evaluation_mode": ev["evaluation_mode"],
                     "evaluation_split_s": {k: spans[f"evaluation_{tag}/{k}"]
                                            for k in ("scan", "visibility", "nn")}}
    print(json.dumps({"benchmark_eth": line}), flush=True)
    for tag in ("ref", "raw"):
        if line[tag]["registered"] != synthetic.ETH_SCENE["num_cameras"]:
            raise RuntimeError(f"benchmark_eth {tag}: {line[tag]['registered']} images registered")

    scan_file = os.path.join(root, "dslr_scan_eval", "scan_alignment.mlp")
    gt_dir = os.path.join(root, "dslr_calibration_undistorted")
    scan, _ = eth3d._load_scan_cached(scan_file, eth3d.SURFACE_SPACING)
    visible = eth3d._visible_scan_cached(scan, scan_file, gt_dir, 1)
    rec = read_ply_xyz(os.path.join(root, "sparse-sift-ref.ply"))

    numbers, d2 = nn_full_size(nn_dist, rec, scan, visible)
    print(json.dumps({"nn_dist_full_size": numbers}), flush=True)

    # (a) The card's evaluation against the host cKDTree route (f64).
    card_ev = results["ref"]["evaluation"]
    check = _kdtree_check("benchmark_eth", card_ev, d2, rec, scan, visible)

    # (b) The visibility mask on the card against the CPU, reduced scan.
    step = max(1, scan.shape[0] // VIS_SAMPLES)
    sub = np.ascontiguousarray(scan[::step], np.float32)
    model = read_model(gt_dir)
    masks = {dev: eth3d.scan_visibility_mask(sub, model, device=dev) for dev in ("cuda", "cpu")}
    differ = np.nonzero(masks["cuda"] != masks["cpu"])[0]
    margins = _depth_margins(sub, model, differ) if len(differ) else np.zeros(0)
    check["visibility"] = {"samples": int(sub.shape[0]), "visible": int(masks["cuda"].sum()),
                           "differ": int(len(differ)),
                           "max_margin": float(margins.max()) if len(differ) else 0.0}
    if len(differ) and not margins.max() <= VIS_RTOL:
        raise RuntimeError(f"benchmark_eth: visibility card vs CPU {check['visibility']}")

    # (c) The accuracy gate and its two controls: raw, and ref shifted.
    shifted = rec + np.array([0.0, 0.0, CONTROL_SHIFT_M])
    control = eth3d.evaluate_point_cloud(shifted, scan, scan_completeness=visible)
    raw_acc = results["raw"]["evaluation"]["accuracies"][0]
    check["accuracy_gate"] = {
        "bound": ETH_ACCURACY_MIN, "ref": card_ev["accuracies"][0], "raw": raw_acc,
        "control_shifted_2cm": control["accuracies"][0]}
    print(json.dumps({"benchmark_eth_check": check}), flush=True)
    if not card_ev["accuracies"][0] >= ETH_ACCURACY_MIN:
        raise RuntimeError(f"benchmark_eth: ref accuracy at 1 cm {card_ev['accuracies'][0]}")
    if raw_acc >= ETH_ACCURACY_MIN or control["accuracies"][0] >= ETH_ACCURACY_MIN:
        raise RuntimeError(f"benchmark_eth: a control passes the accuracy gate {check}")

    dirs = [numbers[k] for k in ("accuracy", "completeness")]
    row = {
        "name": "nn_dist",
        "route": "cuda",
        "source": "lfr_tpu_torch/csrc/nn_dist.cu",
        "replaces": "not a TPU kernel: XLA-fused jnp of lfr_tpu/eval/eth3d.py:234 "
                    "(_all_min_impl) and :283 (_count_within_impl)",
        "ms": sum(d["ms"] for d in dirs),
        "plain_ms": sum(d["plain_ms"] for d in dirs),
        "bound_ms": sum(d["bound_ms"] for d in dirs),
        "bound_by": "operations",
        "library_ms": sum(d["library_ms"] for d in dirs),
        "max_abs_err": max(d["max_abs_err"] for d in dirs),
    }
    return counts, row


def _traced_extract(image_dir):
    """extract_directory under torch.profiler: wall seconds, summed kernel
    time, the device's busy share, launches per view, the kernel ms per
    view of each of SIFT's device stages (the kernels launched inside its
    profiler ranges, sift.STAGES) and the costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lfr_tpu_torch.ops.sift import STAGES
    from lfr_tpu_torch.pipelines.extract_features import extract_directory

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = extract_directory(image_dir, "sift", verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    stages = dict.fromkeys(STAGES, 0.0)
    by_name = {}
    for evt in events:
        if evt.device_type != cuda:
            if evt.name in stages:
                stages[evt.name] += evt.device_time_total / 1e3
        elif not evt.is_user_annotation and evt.name not in stages:
            count, ms = by_name.get(evt.name, (0, 0.0))
            by_name[evt.name] = count + 1, ms + evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    if not 0.0 < sum(stages.values()) <= busy_ms * (1 + 1e-6):
        raise RuntimeError(f"extract: stage kernel ms {stages} against {busy_ms} ms in all")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"views": n, "wall_s": wall, "kernel_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "stage_kernel_ms_per_view": {k: v / n for k, v in stages.items()},
            "launches_per_view": sum(c for k, (c, _) in by_name.items()
                                     if "memcpy" not in k.lower()) / n,
            "top_kernels": [{"name": k[:80], "count": c, "ms": ms} for k, (c, ms) in top[:8]]}


def _card_vs_cpu(view):
    """SIFT, DoH and SURF on one full-size gray view ([0, 1] f64), card
    against CPU, beside the two CPU controls that set the bounds of SIFT
    and DoH; SURF is held to SURF_MIN_SHARE and equal keypoint counts."""
    import torch

    from lfr_tpu_torch.eval.compare import feature_agreement
    from lfr_tpu_torch.ops import doh, sift, surf

    rng = np.random.default_rng(ETH_SEED)
    perturbed = view * (1.0 + PERTURB * rng.standard_normal(view.shape))
    agree = lambda a, b: feature_agreement(a, b, MATCH_PX, DESC_ATOL)  # noqa: E731
    out, failed = {}, []
    for name, fn in (("sift", sift.extract_sift), ("doh", doh.extract_doh),
                     ("surf", surf.extract_surf)):
        fn(view, device="cuda")  # warm-up: cuDNN handles and heuristics
        t0 = time.perf_counter()
        card = fn(view, device="cuda")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = fn(view, device="cpu")
        cpu_s = time.perf_counter() - t0
        with torch.backends.mkldnn.flags(enabled=False):
            cpu_conv = fn(view, device="cpu")
        controls = {"perturbed": agree(cpu, fn(perturbed, device="cpu")),
                    "conv_route": agree(cpu, cpu_conv)}
        got = agree(cpu, card)
        if name == "surf":
            bounds = dict.fromkeys(("matched", "descriptors"), SURF_MIN_SHARE)
        else:
            bounds = {k: min(c[k] for c in controls.values()) - CONTROL_MARGIN
                      for k in ("matched", "descriptors")}
        out[name] = {"card_s": card_s, "cpu_s": cpu_s, "card_vs_cpu": got,
                     "controls": controls, "bounds": bounds}
        if any(got[k] < bounds[k] for k in bounds) or (
                name == "surf" and got["keypoints"][0] != got["keypoints"][1]):
            failed.append(name)
    return out, failed


def extract_phase(nn_dist, scene_root, tmp):
    """SIFT on the benchmark_eth scene's 30 views with the host / device
    split, run_eth from the extracted features on its first EXTRACT_CAMERAS
    cameras with its evaluation checked (nn_dist against its plain version
    at this run's shapes, the fractions against the cKDTree), card vs CPU
    for each extractor, and the fixture JPEGs' host cost, with the
    library's TF32 defaults.  Returns the path's launch counts (extraction
    and run_eth) and nn_dist's largest |kernel - plain|."""
    import torch

    # The library's TF32 defaults, as a user of `extract` has them: the
    # extractors must compute in f32 whatever the flags say.
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        return _extract_phase(nn_dist, scene_root, tmp)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _extract_phase(nn_dist, scene_root, tmp):
    import torch

    from lfr_tpu_torch.config import ETH3D_TOLERANCES
    from lfr_tpu_torch.eval import eth3d
    from lfr_tpu_torch.eval.compare import restrict_to_images
    from lfr_tpu_torch.io import colmap_model
    from lfr_tpu_torch.io.features import load_features
    from lfr_tpu_torch.io.images import load_image_rgb
    from lfr_tpu_torch.pipelines import dataset_tools
    from lfr_tpu_torch.pipelines.benchmark import run_eth
    from lfr_tpu_torch.pipelines.extract_features import extract_directory

    # The scene as a user holds it: images, calibration and scan (with the
    # evaluation's scan cache), no features, no database.
    root = os.path.join(tmp, "eth_extract")
    images = os.path.join(root, "images")
    gt_dir = os.path.join(root, "dslr_calibration_undistorted")
    for sub in ("dslr_calibration_undistorted", "dslr_scan_eval"):
        shutil.copytree(os.path.join(scene_root, sub), os.path.join(root, sub))
    shutil.copytree(os.path.join(scene_root, "images"), images,
                    ignore=shutil.ignore_patterns("*.sift"))
    names = sorted(os.listdir(images))

    reset_launches()
    timing = {}
    t0 = time.perf_counter()
    n_views = extract_directory(images, "sift", verbose=False, timing=timing)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    counts = [load_features(os.path.join(images, n), "sift").num_features for n in names]

    # run_eth on the first EXTRACT_CAMERAS cameras, bootstrapped as a user
    # would: create-db-eth and match-list from the cut calibration.
    keep = set(names[:EXTRACT_CAMERAS])
    for name in names[EXTRACT_CAMERAS:]:
        os.remove(os.path.join(images, name))
        os.remove(os.path.join(images, name + ".sift"))
    colmap_model.write_model(gt_dir, restrict_to_images(colmap_model.read_model(gt_dir), keep))
    dataset_tools.main(["create-db-eth", "--dataset_path", root])
    dataset_tools.main(["match-list", "--dataset_path", root])
    t0 = time.perf_counter()
    results = run_eth(root, "sift", output_path=os.path.join(tmp, "extract_out"),
                      checkpoint=os.path.join(HERE, "weights", "panet_holdout.msgpack"),
                      verbose=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()

    tols = list(ETH3D_TOLERANCES)
    at = [tols.index(0.01), tols.index(0.02)]
    spans = {s["span"]: s["ms"] / 1e3 for s in results["timing"]}
    line = {
        "views": n_views, "view_hw": list(load_image_rgb(os.path.join(images, names[0])).shape[:2]),
        "extract_s": extract_s, "images_per_s": n_views / extract_s,
        "keypoints_per_image": {"min": min(counts), "median": statistics.median(counts),
                                "max": max(counts)},
        "host_ms_per_image": {k: v * 1e3 / n_views for k, v in timing.items()},
        "run_eth": {"cameras": EXTRACT_CAMERAS, "seconds": run_s, "spans_s": spans,
                    "refined_matches": results["match_graph_breakdown"]["n_refined_matches"]},
        "launches": launches,
    }
    for tag in ("ref", "raw"):
        tri, ev = results[tag]["triangulation"], results[tag]["evaluation"]
        line["run_eth"][tag] = {
            "registered": tri["num_reg_images"], "points": tri["num_sparse_points"],
            "mean_reproj_error": tri["mean_reproj_error"],
            "accuracy_1_2cm": [ev["accuracies"][i] for i in at],
            "completeness_1_2cm": [ev["completenesses"][i] for i in at]}
    print(json.dumps({"extract": line}), flush=True)
    for tag in ("ref", "raw"):
        if line["run_eth"][tag]["registered"] != EXTRACT_CAMERAS:
            raise RuntimeError(f"extract: run_eth {tag} registered "
                               f"{line['run_eth'][tag]['registered']} of {EXTRACT_CAMERAS}")
    if min(launches[k] for k in ("corr_sym", "corr_asym", "nn_dist")) == 0:
        raise RuntimeError(f"extract: kernel launches {launches}")

    # This path's evaluation: nn_dist at its own shapes (the points from the
    # extracted features, the samples visible from EXTRACT_CAMERAS cameras)
    # against its plain version, and the fractions against the cKDTree.
    scan_file = os.path.join(root, "dslr_scan_eval", "scan_alignment.mlp")
    scan, _ = eth3d._load_scan_cached(scan_file, eth3d.SURFACE_SPACING)
    visible = eth3d._visible_scan_cached(scan, scan_file, gt_dir, 1)
    rec = colmap_model.read_ply_xyz(os.path.join(root, "sparse-sift-ref.ply"))
    numbers, d2 = nn_full_size(nn_dist, rec, scan, visible, library=False)
    evaluation = _kdtree_check("extract", results["ref"]["evaluation"], d2, rec, scan, visible)
    print(json.dumps({"extract_evaluation": {"nn_dist": numbers, "vs_kdtree": evaluation}}),
          flush=True)
    nn_err = max(numbers[k]["max_abs_err"] for k in ("accuracy", "completeness"))
    del scan, visible, d2

    # Where the device time goes, and the card against the CPU.
    traced_dir = os.path.join(tmp, "extract_traced")
    os.makedirs(traced_dir)
    for n in names[:STAGE_VIEWS]:
        shutil.copy(os.path.join(scene_root, "images", n), traced_dir)
    traced = _traced_extract(traced_dir)
    view = load_image_rgb(os.path.join(traced_dir, names[0])) @ np.array(
        [0.299, 0.587, 0.114]) / 255.0
    agreement, failed = _card_vs_cpu(view)
    jpeg_dir = os.path.join(tmp, "extract_jpeg")
    shutil.copytree(os.path.join(HERE, "tests", "fixtures", "eth3d_mini", "relief_mini", "images"),
                    jpeg_dir)
    jpeg_timing = {}
    n_jpeg = extract_directory(jpeg_dir, "sift", verbose=False, timing=jpeg_timing)
    check = {"traced": traced, "card_vs_cpu": agreement,
             "fixture_jpegs": {"views": n_jpeg,
                               "host_ms_per_image": {k: v * 1e3 / n_jpeg
                                                     for k, v in jpeg_timing.items()}}}
    print(json.dumps({"extract_check": check}), flush=True)
    if failed:
        raise RuntimeError(f"extract: card vs CPU below its bound: {failed}")
    return launches, nn_err


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        out.update(_flat(value, name) if isinstance(value, dict) else {name: np.asarray(value)})
    return out


def _train_groups(keys):
    """Parameters, the head's conv biases (no gradient: the BatchNorm after
    them removes any per-channel constant, so any implementation moves them
    by rounding noise), and the batch statistics."""
    zero = [f"params/refine/conv{i}/bias" for i in range(4)]
    return {"params": [k for k in keys if k.startswith("params") and k not in zero],
            "zero_grad": zero,
            "batch_stats": [k for k in keys if k.startswith("batch_stats")]}


def _relative(a, b, keys, start):
    """|a - b| over |b - start| as norms over the leaves of ``keys``."""
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in keys)
    den = sum(float(np.sum((b[k].astype(np.float64) - start[k]) ** 2)) for k in keys)
    return (num / den) ** 0.5


def _train_step_once(variables, batch, device, mkldnn=True):
    """One f32 Adam step at TRAIN_LR: (loss, variables after, flat)."""
    import torch

    from lfr_tpu_torch.models import panet, train

    with torch.backends.mkldnn.flags(enabled=mkldnn):
        model = train.load_model(variables, torch.float32, device).train()
        optimizer, _ = train.make_optimizer(model, TRAIN_LR)
        ref, tgt, delta = (torch.from_numpy(x).to(device) for x in batch)
        loss = float(train.train_step(model, optimizer, ref, tgt, delta))
    return loss, _flat(panet.to_jax_variables(model))


def _fixture_images():
    from lfr_tpu_torch.io.images import load_image_rgb

    return [load_image_rgb(os.path.join(HERE, "tests", "fixtures", rel)).astype(np.float32)
            for rel in sorted(_fixture_sha256())]


def _traced_train_chunk(variables, images):
    """16 bf16 train steps under torch.profiler after two warm-up steps:
    wall and kernel ms per step, launches per step, busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lfr_tpu_torch.models import train

    model = train.load_model(variables, torch.bfloat16, "cuda").train()
    optimizer, _ = train.make_optimizer(model, TRAIN_LR)
    rng = np.random.default_rng(1)
    batches = [tuple(torch.from_numpy(x).cuda() for x in train.sample_batch(rng, images, TRAIN_BATCH))
               for _ in range(train.CHUNK + 2)]
    for b in batches[:2]:
        train.train_step(model, optimizer, *b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            train.train_step(model, optimizer, *b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for evt in prof.events():
        if evt.device_type == cuda and not evt.is_user_annotation:
            count, ms = by_name.get(evt.name, (0, 0.0))
            by_name[evt.name] = count + 1, ms + evt.time_range.elapsed_us() / 1e3
    n = train.CHUNK
    kernel_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"steps": n, "wall_ms_per_step": wall * 1e3 / n, "kernel_ms_per_step": kernel_ms / n,
            "device_busy_share": kernel_ms / (wall * 1e3),
            "launches_per_step": sum(c for k, (c, _) in by_name.items()
                                     if "memcpy" not in k.lower()) / n,
            "top_kernels": [{"name": k[:80], "count": c, "ms": ms} for k, (c, ms) in top[:8]]}


def train_phase(tmp):
    """PANet training on the card: (a) one f32 step card vs CPU within the
    controls, (b) the training run with its loss gate and learning-rate-0
    control, (c) validation error, checkpoint round trip and refinement
    with the trained weights."""
    import hashlib

    import torch

    from lfr_tpu_torch.models import checkpoint, panet, train
    from lfr_tpu_torch.pipelines.refinement import TwoViewRefiner, prepare_image
    from lfr_tpu_torch.utils import synthetic

    holdout = checkpoint.load_variables(os.path.join(HERE, "weights", "panet_holdout.msgpack"))
    images = _fixture_images()

    # (a) one step, card against CPU, with the two CPU controls.
    batch = train.sample_batch_warped(np.random.default_rng(0), images, TRAIN_CHECK_PAIRS)
    rng = np.random.default_rng(5)
    perturbed = tuple((x * (1 + PERTURB * rng.standard_normal(x.shape))).astype(np.float32)
                      if i < 2 else x for i, x in enumerate(batch))
    t0 = time.perf_counter()
    card_loss, card = _train_step_once(holdout, batch, "cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_loss, cpu = _train_step_once(holdout, batch, "cpu")
    cpu_s = time.perf_counter() - t0
    pert_loss, pert = _train_step_once(holdout, perturbed, "cpu")
    route_loss, route = _train_step_once(holdout, batch, "cpu", mkldnn=False)
    start = _flat(holdout)
    check = {"pairs": TRAIN_CHECK_PAIRS, "card_s": card_s, "cpu_s": cpu_s,
             "loss": {"card": card_loss, "cpu": cpu_loss, "diff": abs(card_loss - cpu_loss),
                      "control": max(abs(pert_loss - cpu_loss), abs(route_loss - cpu_loss))}}
    for name, keys in _train_groups(cpu).items():
        check[name] = {"diff": _relative(card, cpu, keys, start),
                       "control": max(_relative(pert, cpu, keys, start),
                                      _relative(route, cpu, keys, start))}
    check["factor"] = TRAIN_CONTROL_FACTOR
    print(json.dumps({"train_check": check}), flush=True)
    for name in ("loss", "params", "zero_grad", "batch_stats"):
        if not check[name]["diff"] <= TRAIN_CONTROL_FACTOR * check[name]["control"]:
            raise RuntimeError(f"train: card vs CPU {name} {check[name]} beyond "
                               f"{TRAIN_CONTROL_FACTOR} x the control")

    # (b) the training run and its learning-rate-0 control.
    runs = {}
    for label, lr in (("trained", TRAIN_LR), ("lr_0_control", 0.0)):
        timing = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        variables = train.train(num_steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, corpus="synthetic",
                                seed=0, learning_rate=lr, log_every=64, timing=timing)
        seconds = time.perf_counter() - t0
        losses = np.asarray(timing["losses"])
        line = {"run": label, "learning_rate": lr, "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
                "seconds": seconds, "steps_per_s": TRAIN_STEPS / seconds,
                "patch_pairs_per_s": TRAIN_STEPS * TRAIN_BATCH / seconds,
                "host_sampling_ms_per_step": timing["sample"] * 1e3 / TRAIN_STEPS,
                "step_ms_per_step": timing["steps"] * 1e3 / TRAIN_STEPS,
                "loss_first16": float(losses[:16].mean()), "loss_last16": float(losses[-16:].mean()),
                "loss_drop": float(losses[:16].mean() / losses[-16:].mean()),
                "finite": bool(np.isfinite(losses).all()),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(json.dumps({"train": line}), flush=True)
        runs[label] = (line, variables)
    trained_line, trained = runs["trained"]
    if not (trained_line["finite"] and trained_line["loss_drop"] >= TRAIN_LOSS_DROP):
        raise RuntimeError(f"train: loss drop {trained_line['loss_drop']} < {TRAIN_LOSS_DROP}")
    if runs["lr_0_control"][0]["loss_drop"] >= TRAIN_LOSS_DROP:
        raise RuntimeError("train: the learning-rate-0 control passes the loss gate")
    trace = _traced_train_chunk(trained, train.synthetic_images(np.random.default_rng(0)))
    print(json.dumps({"train_trace": trace}), flush=True)

    # (c) validation, checkpoint round trip, refinement with the weights.
    val = train.sample_batch_warped(np.random.default_rng(12345), images, TRAIN_EVAL_PAIRS)
    px = {"before": train.evaluate_px_error(panet.init_variables(0), val),
          "after": train.evaluate_px_error(trained, val)}
    path = os.path.join(tmp, "trained.msgpack")
    checkpoint.save_variables(path, trained)
    loaded = checkpoint.load_variables(path)
    want, got = _flat(trained), _flat(loaded)
    round_trip = list(want) == list(got) and all(
        want[k].dtype == got[k].dtype and want[k].tobytes() == got[k].tobytes() for k in want)
    image1, image2, kps1, kps2, matches = synthetic.bench_workload(np.random.default_rng(0))
    refiner = TwoViewRefiner(loaded, batch_size=BATCH, fine_mode="grid", device="cuda")
    g12, g21 = refiner.refine_matches(prepare_image(image1, "cuda"), kps1,
                                      prepare_image(image2, "cuda"), kps2, matches)
    finite = bool(np.isfinite(g12).all() and np.isfinite(g21).all())
    init = checkpoint.dumps(panet.init_variables(0))
    line = {"init_sha256": hashlib.sha256(init).hexdigest(),
            "val_pairs": TRAIN_EVAL_PAIRS, "val_px_error": px, "round_trip_bit_equal": round_trip,
            "checkpoint_bytes": os.path.getsize(path), "refined_matches": len(matches),
            "refined_finite": finite,
            "refined_center_median_px": float(np.median(np.abs(g12[:, 1, 1]))) * 16.0}
    print(json.dumps({"train_result": line}), flush=True)
    if not (round_trip and finite and all(np.isfinite(v) for v in px.values())):
        raise RuntimeError(f"train: {line}")


def variants_phase():
    """scripts/bench_corr_variants_torch.py's path at B=4096."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import bench_corr_variants_torch

    reset_launches()
    lines = bench_corr_variants_torch.run()
    counts = read_launches()
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
    from lfr_tpu_torch.ops import correlation, cuda_build, nn_dist

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
    from concurrent.futures import ThreadPoolExecutor

    from lfr_tpu_torch.ops import host_build

    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(host_build.build)
        for name, (path, seconds, log) in cuda_build.build_all().items():
            print(f"built {os.path.relpath(path, HERE)} in {seconds:.3f} s", flush=True)
            print(log.strip(), flush=True)
            cuda_build.library(name)
        path, seconds, log = host.result()
    print(f"built {os.path.relpath(path, HERE)} in {seconds:.3f} s (g++)", flush=True)
    if log.strip():
        print(log.strip(), flush=True)
    host_build.library()
    phase("build", t0)

    t0 = time.perf_counter()
    jpeg_phase()
    phase("jpeg", t0)

    t0 = time.perf_counter()
    rows = kernel_phase(correlation)
    nn_err = nn_kernel_check(nn_dist)
    phase("kernels", t0)

    t0 = time.perf_counter()
    conv_rounding_phase()
    phase("conv_rounding", t0)

    paths = {}
    t0 = time.perf_counter()
    paths["two_view"], _ = slice_phase()
    phase("slice", t0)

    tmp = tempfile.mkdtemp(prefix="lfr_match_graph_")
    try:
        t0 = time.perf_counter()
        paths["match_graph"], matches_file = match_graph_phase(tmp)
        phase("match_graph", t0)

        t0 = time.perf_counter()
        solve_phase(matches_file, tmp)
        phase("solve", t0)

        t0 = time.perf_counter()
        reset_launches()
        triangulation_phase(tmp)
        paths["triangulation"] = read_launches()
        phase("triangulation", t0)

        t0 = time.perf_counter()
        reset_launches()
        sfm_phase(tmp)
        paths["sfm"] = read_launches()
        phase("sfm", t0)

        t0 = time.perf_counter()
        paths["benchmark_eth"], nn_row = benchmark_eth_phase(nn_dist, tmp)
        nn_row["max_abs_err"] = max(nn_err, nn_row["max_abs_err"])
        rows.append(nn_row)
        phase("benchmark_eth", t0)

        t0 = time.perf_counter()
        paths["extract_eth"], nn_err = extract_phase(nn_dist, os.path.join(tmp, "eth_scene"), tmp)
        nn_row["max_abs_err"] = max(nn_err, nn_row["max_abs_err"])
        phase("extract", t0)

        t0 = time.perf_counter()
        reset_launches()
        train_phase(tmp)
        paths["train"] = read_launches()
        if not paths["train"]["corr_asym"] > 0:
            raise RuntimeError(f"train: corr_asym was not launched ({paths['train']})")
        phase("train", t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    paths["variants"] = variants_phase()
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
