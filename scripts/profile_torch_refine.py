#!/usr/bin/env python3
"""Where the port's two-view refinement spends its device time.

    python3 scripts/profile_torch_refine.py [--out FILE]

Runs lfr_tpu_torch's TwoViewRefiner on the card on bench.py's workload
(``synthetic.bench_workload``: 480x640 shifted pair, 2048 matches, batch
2048, weights/panet_holdout.msgpack) in both fine modes: one
warm-up call, then one call under torch.profiler.  Prints, per mode, one JSON
line with the call's host-clock time, the summed device time of its kernels,
the device-busy share (kernel time / call time), the time by kernel class
and the ten costliest kernels, and writes the same to ``--out`` as JSON.
Imports torch, numpy and lfr_tpu_torch only.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Kernel classes, by the first pattern found in the kernel's name.
CLASSES = (
    ("correlation (ours)", ("corr_kernel",)),
    ("conv (cuDNN)", ("conv", "xmma", "implicit", "wgrad", "dgrad", "fprop", "sm90_", "cudnn", "cutlass")),
    ("gemm / einsum", ("gemm", "sgemm", "bmm", "dot")),
    ("gather / index", ("index", "gather", "scatter")),
    ("pool", ("pool",)),
    ("copy / layout", ("copy", "transpose", "cat", "nchw", "nhwc", "memcpy", "memset")),
    ("reduce / norm", ("reduce", "norm")),
)


def classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "elementwise / other"


def device_events(prof):
    import torch

    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            yield evt.key, evt.count, getattr(evt, "self_device_time_total", 0.0) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="profile_torch_refine.json")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from lfr_tpu_torch.models.checkpoint import load_variables
    from lfr_tpu_torch.pipelines.refinement import TwoViewRefiner, prepare_image
    from lfr_tpu_torch.utils import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False  # the library's default, as the port runs

    variables = load_variables(os.path.join(HERE, "weights", "panet_holdout.msgpack"))
    image1, image2, kps1, kps2, matches = synthetic.bench_workload(np.random.default_rng(0))
    prep1 = prepare_image(image1, "cuda")
    prep2 = prepare_image(image2, "cuda")

    report = {"card": card, "matches": len(matches), "modes": {}}
    for mode in ("crop", "grid"):
        refiner = TwoViewRefiner(variables, batch_size=2048, fine_mode=mode, device="cuda")
        refiner.refine_matches(prep1, kps1, prep2, kps2, matches)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            refiner.refine_matches(prep1, kps1, prep2, kps2, matches)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3
        kernels = sorted(device_events(prof), key=lambda k: -k[2])
        busy_ms = sum(ms for _, _, ms in kernels)
        by_class = {}
        for name, _, ms in kernels:
            by_class[classify(name)] = by_class.get(classify(name), 0.0) + ms
        row = {
            "call_ms": call_ms,
            "kernel_ms": busy_ms,
            "device_busy_share": busy_ms / call_ms if call_ms else None,
            "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
            "top_kernels": [
                {"name": name[:120], "launches": count, "ms": ms} for name, count, ms in kernels[:10]
            ],
        }
        report["modes"][mode] = row
        print(json.dumps({"mode": mode, **row}), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
