#!/usr/bin/env python3
"""Where the port's match graph spends its time, on the card.

    python3 scripts/profile_torch_match_graph.py [--out FILE]

Writes chip_smoke.py's match-graph scene (``synthetic.match_graph_workload``:
8 PNG views of 1334x2000, 1067x1600 after the sift caps, 4096 planted
keypoints each, 28 exhaustive pairs) to a temporary directory and runs
lfr_tpu_torch's ``compute_match_graph`` on it (crop mode, batches of 2048,
weights/panet_holdout.msgpack) three times: a warm-up (cuDNN builds its
fused convs for each new batch shape), a plain run, and a run under
torch.profiler.  Prints one JSON line with the three runs' host-clock
seconds (traced minus plain is the profiler's cost), the profiled run's
summed kernel time, the device's busy and idle shares of that run, the time
by kernel class, the ten costliest kernels and the ``sub_spans``, and writes
the same to ``--out``.
Imports torch, numpy and lfr_tpu_torch only.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_torch_refine import classify, device_events  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="profile_torch_match_graph.json")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from lfr_tpu_torch.config import get_method
    from lfr_tpu_torch.models.checkpoint import load_variables
    from lfr_tpu_torch.pipelines.match_graph import compute_match_graph
    from lfr_tpu_torch.pipelines.refinement import TwoViewRefiner
    from lfr_tpu_torch.utils import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False  # the library's default, as the port runs

    refiner = TwoViewRefiner(load_variables(os.path.join(HERE, "weights", "panet_holdout.msgpack")),
                             batch_size=2048, fine_mode="crop", device="cuda")
    tmp = tempfile.mkdtemp(prefix="lfr_profile_")
    try:
        scene = synthetic.match_graph_workload(np.random.default_rng(1), tmp)

        def run(spans):
            t0 = time.perf_counter()
            compute_match_graph(tmp, scene["match_list"], get_method("sift"),
                                os.path.join(tmp, "matches.pb"), refiner=refiner,
                                sub_spans=spans, progress=False)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        warmup_s = run({})
        plain_s = run({})
        spans = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_s = run(spans)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = sorted(device_events(prof), key=lambda k: -k[2])
    busy_ms = sum(ms for _, _, ms in kernels)
    by_class = {}
    for name, _, ms in kernels:
        by_class[classify(name)] = by_class.get(classify(name), 0.0) + ms
    report = {
        "card": card,
        "warmup_s": warmup_s,
        "plain_s": plain_s,
        "traced_s": traced_s,
        "kernel_ms": busy_ms,
        "device_busy_share": busy_ms / (traced_s * 1e3),
        "device_idle_share": 1.0 - busy_ms / (traced_s * 1e3),
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"name": name[:120], "launches": count, "ms": ms} for name, count, ms in kernels[:10]
        ],
        "sub_spans": spans,
    }
    print(json.dumps(report), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
