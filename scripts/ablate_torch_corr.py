#!/usr/bin/env python3
"""Where the correlation kernel's time goes, on the card.

    python3 scripts/ablate_torch_corr.py

Builds lfr_tpu_torch/csrc/correlation.cu as it is and, from patched copies
in lfr_tpu_torch/_build/ablate/, with parts of its work switched off, then
times each build's asym (B=4096), sym (B=2048) and matmul (B=4096) entry
points (CUDA-event medians of 20 calls after 3):

* ``full``:         the kernel as it is;
* ``no_stores``:    the tiles are staged but never written to device memory;
* ``no_products``:  no wgmma: the accumulators hold whatever they held,
                    everything else runs (loads, staging, stores);
* ``no_epilogue``:  products and the row norm, but neither staging nor
                    stores;
* ``loads_only``:   the TMA ring alone.

The patched builds compute wrong volumes on purpose: only their times mean
anything.  Last, a device copy of as many bytes as the volume (684 MB read
and written) gives the card's streaming rate.  Prints the card's name and
power limit first.  Imports torch and lfr_tpu_torch only.
"""

import ctypes
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from lfr_tpu_torch.ops import cuda_build  # noqa: E402

#: Text edits that put the switches into a copy of the source.
PATCHES = (
    ("        wgmma_152(acc, ", "        if (ABLATE_PRODUCTS) wgmma_152(acc, "),
    ("        stmatrix_x4(row_addr", "        if (ABLATE_STAGE) stmatrix_x4(row_addr"),
    ("      stmatrix_x2(row_addr", "      if (ABLATE_STAGE) stmatrix_x2(row_addr"),
    ("    for (int c = tid; c < n_chunks; c += kConsumers) {",
     "    for (int c = tid; ABLATE_STORE && c < n_chunks; c += kConsumers) {"),
)
SWITCHES = ("ABLATE_PRODUCTS", "ABLATE_STAGE", "ABLATE_STORE")
VARIANTS = {
    "full": (1, 1, 1),
    "no_stores": (1, 1, 0),
    "no_products": (0, 1, 1),
    "no_epilogue": (1, 0, 0),
    "loads_only": (0, 0, 0),
}


def patched_source() -> str:
    with open(cuda_build.SOURCE) as fh:
        src = fh.read()
    for old, new in PATCHES:
        if old not in src:
            raise RuntimeError(f"ablate: the kernel source no longer contains {old[:60]!r}")
        src = src.replace(old, new, 1)
    return src


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in cuda_build.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    cuda_build.check(lib, lib.lfr_corr_init(), "lfr_corr_init")
    return lib


def time_ms(fn, runs=20, warmup=3):
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
        raise SystemExit("ablate: torch sees no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    out_dir = os.path.join(cuda_build.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    source = os.path.join(out_dir, "correlation_ablate.cu")
    with open(source, "w") as fh:
        fh.write(patched_source())

    gen = torch.Generator(device="cuda").manual_seed(0)
    fa, fb = (F.normalize(torch.randn(4096, 289, 128, generator=gen, device="cuda"), dim=-1)
              .to(torch.bfloat16) for _ in range(2))
    out1 = torch.empty(4096, 289, 289, dtype=torch.bfloat16, device="cuda")
    out2 = torch.empty_like(out1)
    stream = torch.cuda.current_stream().cuda_stream
    args = (fa.data_ptr(), fb.data_ptr(), out1.data_ptr())
    for name, values in VARIANTS.items():
        lib_path = os.path.join(out_dir, f"lib{name}.so")
        flags = [f"-D{k}={v}" for k, v in zip(SWITCHES, values)]
        proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *flags,
                               "-o", lib_path, source], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"ablate: nvcc failed for {name}:\n{proc.stderr[-4000:]}")
        lib = load(lib_path)
        for entry, code in (("lfr_corr_asym", lib.lfr_corr_asym(*args, 4096, stream)),
                            ("lfr_corr_sym", lib.lfr_corr_sym(*args, out2.data_ptr(), 2048,
                                                              stream))):
            cuda_build.check(lib, code, f"{name} {entry}")
        asym = time_ms(lambda: lib.lfr_corr_asym(*args, 4096, stream))
        sym = time_ms(lambda: lib.lfr_corr_sym(*args, out2.data_ptr(), 2048, stream))
        matmul = time_ms(lambda: lib.lfr_corr_matmul(*args, 4096, stream))
        print(f"{name:12s} asym B=4096 {asym:.4f} ms  sym B=2048 {sym:.4f} ms  "
              f"matmul B=4096 {matmul:.4f} ms", flush=True)
    copy_ms = time_ms(lambda: out2.copy_(out1))
    print(f"device copy of 684 MB (read and write) {copy_ms:.4f} ms = "
          f"{2 * out1.numel() * 2 / (copy_ms * 1e-3) / 1e12:.3f} TB/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
