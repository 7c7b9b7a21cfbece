"""Microbenchmark of the port's correlation-kernel variants on one NVIDIA GPU.

The PyTorch / CUDA counterpart of scripts/bench_corr_variants.py: it splits
the cost of the asym correlation kernel into its parts by timing, at the
same B = 4096 pairs of bf16 (289, 128) feature maps,

* the port's hand-written CUDA kernels (lfr_tpu_torch/csrc/correlation.cu):
  matmul + ReLU + row norm (``corr_asym``), matmul + ReLU (``corr_nonorm``)
  and matmul alone (``corr_matmul``);
* two PyTorch calls in place of the JAX script's XLA ones: bf16 ``bmm`` +
  ReLU + ``F.normalize``, and bf16 ``bmm`` alone (yardsticks, never called
  by the port).

One line per variant, in the JAX script's format: ms per call (CUDA events,
mean over the timed calls after warm-up), TF/s and GB/s over the bytes the
function must move (both inputs read once, the bf16 output written once).

    python scripts/bench_corr_variants_torch.py

Needs a CUDA device; imports torch and lfr_tpu_torch only.
"""

from __future__ import annotations

import os
import subprocess
import sys

B = 4096
P = 289
CH = 128


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean ms of fn() over ``reps`` back-to-back calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def report(name: str, ms: float) -> dict:
    traffic = B * P * CH * 2 * 2 + B * P * P * 2  # in bf16 + out bf16
    gbs = traffic / (ms / 1e3) / 1e9
    flops = B * P * P * CH * 2
    tfs = flops / (ms / 1e3) / 1e12
    print(f"{name:38s} {ms:8.3f} ms   {tfs:6.2f} TF/s  {gbs:7.1f} GB/s", flush=True)
    return {"name": name, "ms": ms, "tf_per_s": tfs, "gb_per_s": gbs}


def run() -> list:
    """Time every variant at B pairs on the current CUDA device; returns one
    dict per report line."""
    import torch
    import torch.nn.functional as F

    from lfr_tpu_torch.ops import correlation

    gen = torch.Generator(device="cuda").manual_seed(0)
    fr = torch.randn(B, P, CH, generator=gen, device="cuda").to(torch.bfloat16)
    ft = torch.randn(B, P, CH, generator=gen, device="cuda").to(torch.bfloat16)
    variants = [
        ("cuda matmul+relu+norm (corr_asym)", lambda: correlation.correlation_asym(fr, ft)),
        ("cuda matmul+relu (corr_nonorm)", lambda: correlation.correlation_nonorm(fr, ft)),
        ("cuda matmul only (corr_matmul)", lambda: correlation.correlation_matmul(fr, ft)),
        ("torch bmm+relu+normalize -> bf16",
         lambda: F.normalize(torch.bmm(fr, ft.mT).relu_(), dim=-1)),
        ("torch bmm only -> bf16", lambda: torch.bmm(fr, ft.mT)),
    ]
    return [report(name, time_ms(fn)) for name, fn in variants]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_corr_variants_torch: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} ({card})  B={B}")
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
