#!/usr/bin/env python3
"""Where the port's multi-view solve spends its time, on the card.

    python3 scripts/profile_torch_solve.py [--out FILE]

Builds ``synthetic.solver_graph(np.random.default_rng(0), **GRAPH)``
(scripts/bench_solver.py's second graph and chip_smoke.py's "full" graph:
about 150k nodes and 2.2M directed edges) and runs lfr_tpu_torch's ``solve_matches`` on it on the
card three times: a warm-up (cuBLAS and cuSOLVER handles, the caching
allocator), a plain run under ``torch.cuda.set_sync_debug_mode("warn")``,
which counts the host syncs, and a run under torch.profiler.  Prints one
JSON line with:

- each run's host-clock seconds and ``sub_spans`` (host stages, LM phases,
  counters, among them ``lm_steps``);
- the traced run's summed kernel time, the device's busy and idle shares of
  the whole solve and of its LM window (``lm_wall``: first pack to last
  read-back);
- device time by class (Cholesky and triangular solves, the assembly's
  products, elementwise, reductions, copies) and the ten costliest kernels;
- kernel launches per LM step and host syncs per LM step;

writes the same to ``--out``, and prints the card's name and power limit.
Imports torch, numpy and lfr_tpu_torch only.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The profiled graph: 30 images, 10000 points.
GRAPH = dict(n_images=30, n_points=10000)

#: Kernel classes by name fragment, first match wins.
CLASSES = (
    ("cholesky / triangular solve", ("potrf", "trsm", "trsv", "cholesky", "magma", "potrs")),
    ("assembly products (gemm)", ("gemm", "cutlass", "xmma", "sm90_", "gemv")),
    ("copies / fills", ("copy", "memcpy", "memset", "fill")),
    ("reductions", ("reduce",)),
    ("gather / index", ("gather", "index", "scatter")),
)


def classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "elementwise / other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="profile_torch_solve.json")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from lfr_tpu_torch.solver.solve import solve_matches
    from lfr_tpu_torch.utils import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    t0 = time.perf_counter()
    pairs = synthetic.solver_graph(np.random.default_rng(0), **GRAPH)
    build_s = time.perf_counter() - t0

    def run(spans):
        t0 = time.perf_counter()
        solve_matches(pairs, device="cuda", verbose=False, sub_spans=spans)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    runs = {"warmup": {}, "plain": {}, "traced": {}}
    seconds = {"warmup": run(runs["warmup"])}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            seconds["plain"] = run(runs["plain"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message).lower() for w in caught)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        seconds["traced"] = run(runs["traced"])

    kernels = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((evt.key, evt.count, getattr(evt, "self_device_time_total", 0.0) / 1e3))
    kernels.sort(key=lambda k: -k[2])
    busy_ms = sum(ms for _, _, ms in kernels)
    launches = sum(count for name, count, _ in kernels if "memcpy" not in name.lower())
    by_class = {}
    for name, _, ms in kernels:
        by_class[classify(name)] = by_class.get(classify(name), 0.0) + ms
    traced = runs["traced"]
    lm_wall_ms = traced["lm_wall"]["total_s"] * 1e3
    report = {
        "card": card,
        "graph": {**GRAPH, "nodes": traced["n_nodes"],
                  "edges": traced["n_edges"], "build_s": build_s},
        "seconds": seconds,
        "kernel_ms": busy_ms,
        "device_busy_share": busy_ms / (seconds["traced"] * 1e3),
        "device_idle_share": 1.0 - busy_ms / (seconds["traced"] * 1e3),
        "lm_window_busy_share": busy_ms / lm_wall_ms,
        "lm_window_idle_share": 1.0 - busy_ms / lm_wall_ms,
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "kernel_launches": launches,
        "lm_steps": traced["lm_steps"],
        "launches_per_lm_step": launches / max(traced["lm_steps"], 1),
        "host_syncs": syncs,
        "host_syncs_per_lm_step": syncs / max(runs["plain"]["lm_steps"], 1),
        "top_kernels": [
            {"name": name[:120], "launches": count, "ms": ms} for name, count, ms in kernels[:10]
        ],
        "sub_spans": runs,
    }
    print(json.dumps(report), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
