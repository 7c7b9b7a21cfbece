#!/usr/bin/env python3
"""Which collectives two ranks sharing one card can run, on the card.

    python3 scripts/probe_torch_collectives.py

Two ranks spawned by ``lfr_tpu_torch.parallel.multiprocess.run_ranks`` on
cuda:0 form a gloo process group (the port's choice for ranks that share a
card) and try all_reduce, broadcast and all_gather of f32 CUDA tensors and
an all_reduce of a bf16 one, each checked against its expected value.
Then two ranks bypass the port's backend rule and ask NCCL for the same
card, the error (or success) of the first all_reduce recorded.  Prints one
JSON line and the card's name and power limit.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _gloo_ops(n):
    import torch
    import torch.distributed as dist

    res = {"backend": dist.get_backend()}
    rank = dist.get_rank()

    def all_gather():
        x = torch.full((4,), float(rank), device="cuda")
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return torch.cat(parts).tolist() == [float(r) for r in range(n) for _ in range(4)]

    def all_reduce(dtype):
        x = torch.ones(4, device="cuda", dtype=dtype)
        dist.all_reduce(x)
        return x.float().tolist() == [float(n)] * 4

    def broadcast():
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.broadcast(x, 0)
        return x.tolist() == [1.0] * 4

    for name, op in (("all_reduce", lambda: all_reduce(torch.float32)),
                     ("broadcast", broadcast), ("all_gather", all_gather),
                     ("all_reduce_bf16", lambda: all_reduce(torch.bfloat16))):
        try:
            res[name] = "ok" if op() else "wrong value"
        except RuntimeError as exc:
            res[name] = repr(exc)[:200]
    return res


def _nccl_rank(rank, n, port):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=n)
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    dist.destroy_process_group()


def main():
    import torch

    from lfr_tpu_torch.parallel.multiprocess import free_port, run_ranks

    if not torch.cuda.is_available():
        raise RuntimeError("probe_torch_collectives.py needs a CUDA device")
    if len(sys.argv) > 1 and sys.argv[1] == "--nccl-ranks":
        torch.multiprocessing.spawn(_nccl_rank, args=(2, free_port()), nprocs=2)
        return
    line = {"torch": torch.__version__, "gloo_shared_card": run_ranks(_gloo_ops, 2, args=(2,))}
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--nccl-ranks"],
                              capture_output=True, text=True, timeout=120)
        out = proc.stdout + proc.stderr
        hit = [ln for ln in out.splitlines() if "Duplicate GPU" in ln or "NCCL error" in ln]
        line["nccl_shared_card"] = {"rc": proc.returncode, "error": hit[-2:]}
    except subprocess.TimeoutExpired:
        line["nccl_shared_card"] = {"rc": None, "error": ["timed out after 120 s"]}
    version = torch.cuda.nccl.version()
    line["nccl_version"] = ".".join(map(str, version)) if isinstance(version, tuple) else version
    print(json.dumps({"collectives": line}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
