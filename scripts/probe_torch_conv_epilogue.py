#!/usr/bin/env python3
"""How the port's conv epilogue rounds, and what it costs, on the card.

    python3 scripts/probe_torch_conv_epilogue.py

The JAX ``_FoldedConv`` sums a bf16 conv in f32, adds the f32 bias, applies
ReLU and rounds to bf16 once.  For each conv shape of the port's main path
(backbone at the coarse 33x33 and crop 65x65 sizes, the four head convs)
this times four ways to compute it in PyTorch and counts the elements that
differ from the one-rounding result (an f32 conv of the same bf16 operands,
TF32 off):

* ``two_pass``:       bf16 conv, then the f32 bias added in place, ReLU
                      (lfr_tpu_torch.models.panet.FoldedConv);
* ``fused_f32_bias``: ``torch.cudnn_convolution_relu`` with the f32 bias;
* ``fused_bf16_bias``: the same with the bias rounded to bf16;
* ``conv_bf16_bias``: ``F.conv2d`` with the bf16 bias, then ReLU.

Inputs are seeded random values of the layer's shape.  Prints the card's
name and power limit, then one line per layer; a variant cuDNN refuses is
reported as its error.
"""

import statistics
import subprocess

import torch
import torch.nn.functional as F

#: (name, batch, in channels, out channels, input size, kernel, padding).
LAYERS = (
    ("conv1_1 coarse", 4096, 3, 64, 33, 3, 1),
    ("conv1_2 coarse", 4096, 64, 64, 33, 3, 1),
    ("conv2_1 coarse", 4096, 64, 128, 17, 3, 1),
    ("conv2_2 coarse", 4096, 128, 128, 17, 3, 1),
    ("conv1_1 crop", 8192, 3, 64, 65, 3, 1),
    ("conv1_2 crop", 8192, 64, 64, 65, 3, 1),
    ("conv2_1 crop", 8192, 64, 128, 33, 3, 1),
    ("head conv0", 4096, 289, 128, 17, 5, 0),
    ("head conv1", 4096, 128, 128, 13, 5, 0),
    ("head conv2", 4096, 128, 64, 9, 5, 0),
    ("head conv3", 4096, 64, 64, 5, 5, 0),
)


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} cudnn {torch.backends.cudnn.version()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, batch, cin, cout, size, k, pad in LAYERS:
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
        b16 = b.to(torch.bfloat16)
        exact = F.conv2d(x.float(), w.float(), padding=pad).add_(b.view(1, -1, 1, 1))
        exact = exact.relu_().to(torch.bfloat16).float()
        args = ([1, 1], [pad, pad], [1, 1], 1)
        variants = {
            "two_pass": lambda: F.conv2d(x, w, padding=pad).add_(b.view(1, -1, 1, 1)).relu_(),
            "fused_f32_bias": lambda: torch.cudnn_convolution_relu(x, w, b, *args),
            "fused_bf16_bias": lambda: torch.cudnn_convolution_relu(x, w, b16, *args),
            "conv_bf16_bias": lambda: F.conv2d(x, w, b16, padding=pad).relu_(),
        }
        row = {}
        for vname, fn in variants.items():
            try:
                y = fn()
                torch.cuda.synchronize()
            except RuntimeError as err:  # a refused variant is a result
                row[vname] = f"error: {err}"[:160]
                continue
            diff = (y.float() - exact).abs()
            row[vname] = {
                "differ_share": (diff > 0).float().mean().item(),
                "max_rel": (diff / exact.abs().clamp_min(1e-3)).max().item(),
                "ms": time_ms(fn),
            }
            del y, diff
        print(name, f"B={batch} {cin}->{cout} {size}x{size}", row, flush=True)
        del x, exact
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
