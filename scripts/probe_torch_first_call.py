#!/usr/bin/env python3
"""What BuildMeter's synchronisation around a conv shape's first call costs.

    python3 scripts/probe_torch_first_call.py [--runs 2]

``lfr_tpu_torch.utils.timing.BuildMeter.first_call`` synchronises the card
before and after the first call of each conv shape to time cuDNN's start-up
for it.  This runs chip_smoke.py's match-graph phase (8 PNG views of
1334x2000, 28 pairs, crop mode) in fresh processes, alternating the meter
as it is ("sync") and a copy that times the first call by the host clock
alone ("nosync"), ``--runs`` times each, sync first.  One JSON line a run:
the phase's seconds and the meter's report; then the card's name and power
limit.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _one(variant):
    import torch

    import chip_smoke
    from lfr_tpu_torch.ops import cuda_build, host_build
    from lfr_tpu_torch.utils.timing import BuildMeter

    if variant == "nosync":
        def first_call(key, device, fn):
            if device.type != "cuda" or key in BuildMeter._seen:
                return fn()
            BuildMeter._seen.add(key)
            t0 = time.perf_counter()
            out = fn()
            BuildMeter.add("cudnn_first_call", time.perf_counter() - t0)
            return out

        BuildMeter.first_call = staticmethod(first_call)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    cuda_build.build_all()
    host_build.build()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        chip_smoke.match_graph_phase(tmp)
        seconds = time.perf_counter() - t0
    print(json.dumps({"first_call": {"variant": variant, "match_graph_s": seconds,
                                     "meter": BuildMeter.report()}}), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--variant", choices=["sync", "nosync"], default=None)
    args = parser.parse_args()
    if args.variant:
        _one(args.variant)
        return
    for i in range(2 * args.runs):
        variant = ("sync", "nosync", "nosync", "sync")[i % 4]
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant", variant],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{variant} run failed:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        print([ln for ln in proc.stdout.splitlines() if ln.startswith('{"first_call"')][-1],
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
