"""Device health probe: attribute wall-clock variance to the environment,
not the pipeline (port of lfr_tpu/utils/healthprobe.py).

``probe()`` times two fixed micro-operations whose cost does not depend on
the workload:

- ``roundtrip_ms``: a fresh 4-byte device->host read (a fill, the copy and
  the sync: the link's and the runtime's latency);
- ``matmul_ms``: a fixed 1024^3 bf16 product summed to a scalar, including
  the sync (device compute and dispatch; ``torch.matmul`` is fine here, it
  is a probe, not a kernel of the port).

On a CUDA device it also reads the caching allocator under the JAX
package's names: ``mb_in_use`` (``torch.cuda.memory_allocated``) and
``peak_mb_in_use`` (``max_memory_allocated``), in 1e6 bytes.  JAX's
``largest_free_block_mb`` has no counterpart in torch's allocator.  A
stage outlier whose surrounding probes also balloon is an environment
stall; one with steady probes implicates the pipeline.
"""

from __future__ import annotations

import time

import torch

from ..device import resolve_device

_probe_state = {}


def probe(device="cuda") -> dict:
    """A snapshot of a few ms: {"roundtrip_ms", "matmul_ms"} and, on a CUDA
    device, {"mb_in_use", "peak_mb_in_use"}."""
    dev = resolve_device(device)
    st = _probe_state.setdefault(str(dev), {})
    if "x" not in st:
        st["x"] = torch.full((1024, 1024), 0.5, dtype=torch.bfloat16, device=dev)
        float(torch.matmul(st["x"], st["x"]).sum(dtype=torch.float32))  # warm outside the timing
        st["n"] = 0

    # A fresh scalar each call: a reused tensor would time no transfer.
    st["n"] += 1
    t0 = time.perf_counter()
    float(torch.full((), st["n"], dtype=torch.float32, device=dev))
    roundtrip_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    float(torch.matmul(st["x"], st["x"]).sum(dtype=torch.float32))
    matmul_ms = (time.perf_counter() - t0) * 1e3
    out = {"roundtrip_ms": roundtrip_ms, "matmul_ms": matmul_ms}
    if dev.type == "cuda":
        out["mb_in_use"] = torch.cuda.memory_allocated(dev) / 1e6
        out["peak_mb_in_use"] = torch.cuda.max_memory_allocated(dev) / 1e6
    return out
