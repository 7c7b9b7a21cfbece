#!/usr/bin/env python3
"""How the port's conv epilogue rounds, and what it costs, on the card.

    python3 scripts/probe_torch_conv_epilogue.py [--benchmark 0|1]

The JAX ``_FoldedConv`` sums a bf16 conv in f32, adds the f32 bias, applies
ReLU and rounds to bf16 once.  For each conv shape of the port's main path
(``lfr_tpu_torch.models.panet.MAIN_PATH_CONVS`` at the batch of a 2048-match
refinement batch) this times ways to compute it in PyTorch and counts the
elements that differ from the one-rounding result (an f32 conv of the same
bf16 operands, TF32 off):

* ``two_pass``:       bf16 conv, then the f32 bias added in place, ReLU
                      (the port's earlier FoldedConv: two roundings);
* ``fused_f32_bias``: ``torch.cudnn_convolution_relu`` with the f32 bias;
* ``fused_pad``:      the same after zero channels pad input and weight to a
                      multiple of 8 (no sum changes);
* ``f32_conv``:       an f32 conv of the bf16 operands in TF32 (bf16 values
                      and their products are exact there), then
                      ``torch.add(y, bias, out=bf16)`` and an in-place ReLU;
* ``folded_conv``:    ``lfr_tpu_torch.models.panet.FoldedConv`` as the port
                      runs it (``fused_pad`` where the channels are no
                      multiple of 8, else ``fused_f32_bias``).

``--benchmark`` sets ``torch.backends.cudnn.benchmark`` (default 0, the
library's default and what the port runs: cuDNN's heuristics choose; 1:
cuDNN times its engines at each new shape).  Each
variant reports ``first_ms`` (host clock around its first call, which pays
that choice) and ``ms`` (CUDA-event median of 10 later calls).  Inputs are
seeded random values of the layer's shape.  Prints the card's name and
power limit, then one line per layer; a variant cuDNN refuses is reported
as its error.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from lfr_tpu_torch.models.panet import MAIN_PATH_CONVS, FoldedConv, pad_channels  # noqa: E402

#: Batch of each layer at the main path's 2048-match batch: the coarse
#: pass's backbone and head see 4096 patches, the crop pass's backbone 8192.
def batch_of(name):
    return 8192 if name.endswith("crop") else 4096


def time_ms(fn, runs=10, warmup=3):
    """Median of ``runs`` CUDA-event timings of fn(), after ``warmup`` calls."""
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


@torch.inference_mode()
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--benchmark", type=int, default=0, choices=(0, 1))
    args_ = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = bool(args_.benchmark)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} cudnn {torch.backends.cudnn.version()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"cudnn.benchmark={torch.backends.cudnn.benchmark}")
    for name, cin, cout, size, k, pad in MAIN_PATH_CONVS:
        batch = batch_of(name)
        if cin == 289:  # the head's input: a permuted view of the (B, 17, 17, 289) volume
            x = torch.rand(batch, size, size, cin, generator=gen, device="cuda")
            x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        else:
            x = torch.rand(batch, cin, size, size, generator=gen, device="cuda")
            x = x * 255 if cin == 3 else x  # raw pixels
            x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w = torch.randn(cout, cin, k, k, generator=gen, device="cuda") / (cin * k * k) ** 0.5
        w = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        b = torch.randn(cout, generator=gen, device="cuda") * 0.5
        exact = F.conv2d(x.float(), w.float(), padding=pad).add_(b.view(1, -1, 1, 1))
        exact = exact.relu_().to(torch.bfloat16).float()
        args = ([1, 1], [pad, pad], [1, 1], 1)
        conv = FoldedConv(cin, cout, k, pad).cuda()
        with torch.no_grad():
            conv.weight.copy_(w.float())
            conv.bias.copy_(b)

        def f32_conv():
            torch.backends.cudnn.allow_tf32 = True
            y = F.conv2d(x.float(), w.float(), padding=pad)
            torch.backends.cudnn.allow_tf32 = False
            out = torch.empty(y.shape, dtype=torch.bfloat16, device=y.device,
                              memory_format=torch.channels_last)
            return torch.add(y, b.view(1, -1, 1, 1), out=out).relu_()

        variants = {
            "two_pass": lambda: F.conv2d(x, w, padding=pad).add_(b.view(1, -1, 1, 1)).relu_(),
            "fused_f32_bias": lambda: torch.cudnn_convolution_relu(x, w, b, *args),
            "f32_conv": f32_conv,
            "fused_pad": lambda: torch.cudnn_convolution_relu(
                pad_channels(x), pad_channels(w).contiguous(memory_format=torch.channels_last),
                b, *args),
            "folded_conv": lambda: conv(x),
        }
        row = {}
        for vname, fn in variants.items():
            try:
                t0 = time.perf_counter()
                y = fn()
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
            except RuntimeError as err:  # a refused variant is a result
                row[vname] = f"error: {err}"[:160]
                continue
            diff = (y.float() - exact).abs()
            row[vname] = {
                "first_ms": first_ms,
                "differ_share": (diff > 0).float().mean().item(),
                "max_rel": (diff / exact.abs().clamp_min(1e-3)).max().item(),
                "ms": time_ms(fn),
            }
            del y, diff
        print(name, f"B={batch} {cin}->{cout} {size}x{size} padded={cin % 8 != 0}", row, flush=True)
        del x, exact
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
