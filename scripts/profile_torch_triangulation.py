#!/usr/bin/env python3
"""Where the port's fixed-pose triangulation chain spends its time, on the card.

    python3 scripts/profile_torch_triangulation.py [--out FILE]

Writes ``synthetic.triangulation_workload(np.random.default_rng(2), ...)``
at chip_smoke.py's full size (30 ETH3D DSLR cameras, 20,000 points, about
half a million putative matches, 10% rewired) into a temporary directory
and runs lfr_tpu_torch's chain on it on the card, ref (with the planted
SolutionFile):

1. ``triangulation_pipeline`` twice, a warm-up and a plain run: host-clock
   seconds and the spans (summed over chunks), and the MatchingFile's
   decode alone (the rest of the ``matches`` span is sqlite writes);
2. its two device stages alone on a fresh copy of the database, each under
   ``torch.cuda.set_sync_debug_mode("warn")`` (host syncs) and then each
   under torch.profiler: ``import_features`` (keypoints, matches, then the
   batched RANSAC ``verify``) and ``triangulate_model`` (tracks, pack,
   device, gate).

Prints one JSON line with the spans, each stage's summed kernel time and
the device's busy and idle shares of its ``verify`` span and of its
``triangulate`` span (and of the ``device`` sub-span), kernel launches and
host syncs per verify batch and per triangulation chunk, device time by op
class and the ten costliest kernels; writes the same to ``--out``, and
prints the card's name and power limit.  Imports torch, numpy and
lfr_tpu_torch only.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The profiled scene (chip_smoke.py's TRI_SCENE).
SCENE = dict(num_cameras=30, num_points=20000)

#: Kernel classes by name fragment, first match wins.
CLASSES = (
    ("LU / solves (solve_ex)", ("getrf", "getrs", "trsm", "trsv", "lu_", "magma", "solve")),
    ("products (gemm)", ("gemm", "cutlass", "xmma", "sm90_", "gemv", "dot")),
    ("copies / fills", ("copy", "memcpy", "memset", "fill")),
    ("sort", ("sort", "radix")),
    ("reductions", ("reduce",)),
    ("gather / index", ("gather", "index", "scatter")),
)


def classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "elementwise / other"


def _spans(report):
    out = {}
    for s in report:
        out[s["span"]] = out.get(s["span"], 0.0) + s["ms"] / 1e3
    return out


def _kernels(prof, torch):
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((evt.key, evt.count, getattr(evt, "self_device_time_total", 0.0) / 1e3))
    return sorted(rows, key=lambda k: -k[2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="profile_torch_triangulation.json")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from lfr_tpu_torch.io import colmap_db, colmap_model, protos
    from lfr_tpu_torch.pipelines.import_features import import_features
    from lfr_tpu_torch.pipelines.triangulation import triangulation_pipeline
    from lfr_tpu_torch.sfm.triangulate import triangulate_model
    from lfr_tpu_torch.utils import synthetic, timing

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    tmp = tempfile.mkdtemp(prefix="lfr_profile_tri_")
    try:
        root = os.path.join(tmp, "scene")
        t0 = time.perf_counter()
        truth = synthetic.triangulation_workload(np.random.default_rng(2), root, **SCENE)
        build_s = time.perf_counter() - t0
        matches, solution = truth["matches_file"], truth["solution_file"]

        def pipeline():
            for name in os.listdir(root):
                if name.startswith(("sift-ref", "sparse-sift-ref")):
                    path = os.path.join(root, name)
                    shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
            t0 = time.perf_counter()
            stats = triangulation_pipeline(root, "sift", matches, solution, verbose=False)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, stats

        seconds, runs = {}, {}
        for name in ("warmup", "plain"):
            seconds[name], stats = pipeline()
            runs[name] = _spans(stats["timing"])
        batches = stats["matching"]["verify_batches"]
        # The decoder's part of the ``matches`` span (the rest is sqlite).
        t0 = time.perf_counter()
        protos.read_matching_file(matches)
        seconds["matching_file_decode"] = time.perf_counter() - t0

        # The two device stages alone, on a fresh copy of the database.
        db_path = os.path.join(tmp, "stages.db")
        empty = colmap_model.read_model(os.path.join(root, "sparse-sift-ref-empty"))
        images = os.path.join(root, "images")

        def verify_stage(spans):
            shutil.copyfile(os.path.join(root, "database.db"), db_path)
            import_features("sift", db_path, images, matches, solution, verbose=False,
                            spans=spans)
            torch.cuda.synchronize()

        def triangulate_stage(spans):
            db = colmap_db.ColmapDatabase(db_path)
            with spans.span("triangulate"):
                result = triangulate_model(db, empty, spans=spans)
            db.close()
            torch.cuda.synchronize()
            return result

        stages = {}
        for name, fn in (("verify", verify_stage), ("triangulate", triangulate_stage)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn(timing.Spans())
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sum("synchroniz" in str(w.message).lower() for w in caught)
            spans = timing.Spans()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn(spans)
            kernels = _kernels(prof, torch)
            busy_ms = sum(ms for _, _, ms in kernels)
            launches = sum(count for k, count, _ in kernels if "memcpy" not in k.lower())
            traced = _spans(spans.report())
            windows = {"verify": ["verify"],
                       "triangulate": ["triangulate", "triangulate/device"]}[name]
            by_class = {}
            for k, _, ms in kernels:
                by_class[classify(k)] = by_class.get(classify(k), 0.0) + ms
            units = batches if name == "verify" else max(
                sum(1 for s in spans.report() if s["span"] == "triangulate/device"), 1)
            stages[name] = {
                "kernel_ms": busy_ms,
                "traced_spans_s": traced,
                "busy_share": {w: busy_ms / (traced[w] * 1e3) for w in windows},
                "idle_share": {w: 1.0 - busy_ms / (traced[w] * 1e3) for w in windows},
                "kernel_launches": launches,
                "host_syncs": syncs,
                "units": units,
                "launches_per_unit": launches / units,
                "host_syncs_per_unit": syncs / units,
                "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
                "top_kernels": [{"name": k[:120], "launches": c, "ms": ms}
                                for k, c, ms in kernels[:10]],
            }
        report = {
            "card": card,
            "scene": {**SCENE, "build_s": build_s, "pairs": stats["matching"]["num_putative_pairs"],
                      "tracks": stats["num_tracks"], "verify_batches": batches},
            "seconds": seconds,
            "spans_s": runs,
            "pairs_per_s_verify": stats["matching"]["num_putative_pairs"]
            / runs["plain"]["import_verify/verify"],
            "tracks_per_s_device": stats["num_tracks"] / runs["plain"]["triangulate/device"],
            "stages": stages,
            "note": "units: verify batches for verify, device chunks for triangulate",
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
