"""Nearest-neighbour distances of the ETH3D evaluation: a CUDA kernel and
its plain version.

For queries q (Q, 3) and a corpus c (C, 3), both f32:

    min_sq[i] = min_j (qx_i - cx_j)^2 + (qy_i - cy_j)^2 + (qz_i - cz_j)^2

in the direct squared-difference form as fma(dz, dz, fma(dy, dy, dx * dx)),
the fused form that XLA gives the JAX package's ``_all_min_impl``
(lfr_tpu/eval/eth3d.py:234-249) on the CPU.  The matmul identity is ruled
out by its cancellation (eth3d.py:203-210).

The kernel (``csrc/nn_dist.cu``, built by nvcc for sm_90a, see
``cuda_build``) replaces no TPU kernel: it does on the card what XLA's
fusion of ``_all_min_impl`` and ``_count_within_impl`` (:283-305) did on the
TPU.  It is bound by FP32 instruction issue (7 instructions a pair).  Its
grid splits the corpus as well as the queries, so a few hundred queries
against tens of millions of scan samples still fill the card, and the
blocks' partial minima meet by ``atomicMin`` on the f32 bit patterns
(order-free, so deterministic).

A CPU tensor goes to the plain version, :func:`min_sq_reference`: a
chunked broadcast that forms each fused multiply-add in f64 (the product of
two f32 values is exact there) and rounds it to f32, which equals the fused
result except where the f64 sum itself rounds onto an f32 midpoint (about
one sum in 2^29).  A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from . import cuda_build

#: Threads per block and corpus points per shared-memory tile of the kernel.
THREADS = 256
TILE = 1024

#: Blocks of THREADS per SM that the launch plan aims for: 2048 threads,
#: an SM's maximum.
BLOCKS_PER_SM = 8

#: Kernel launches, counted where the kernel is launched.
LAUNCHES = {"nn_dist": 0}


def reset_launches() -> None:
    LAUNCHES["nn_dist"] = 0


def launch_plan(nq: int, nc: int, sms: int) -> Tuple[int, int]:
    """(queries a thread, corpus points a block) for Q = ``nq`` queries and
    C = ``nc`` corpus points on a card of ``sms`` SMs.

    Four queries a thread (one shared-memory load serves four pairs) once
    the queries alone give every SM four blocks; one otherwise, so that a
    few hundred queries still spread over several blocks.  The corpus is
    split into chunks of whole tiles until the grid holds BLOCKS_PER_SM
    blocks an SM."""
    qpt = 4 if nq >= 4 * THREADS * sms else 1
    qblocks = -(-nq // (THREADS * qpt))
    tiles = max(1, -(-nc // TILE))
    splits = max(1, min(tiles, -(-BLOCKS_PER_SM * sms // max(qblocks, 1))))
    return qpt, -(-tiles // splits) * TILE


def min_sq_reference(q: torch.Tensor, c: torch.Tensor, q_chunk: int = 1024,
                     c_chunk: int = 4096) -> torch.Tensor:
    """Plain version: (Q, 3) x (C, 3) f32 -> (Q,) f32 squared distance to
    the nearest corpus point (+inf when C is 0), by chunked broadcast."""
    nq, nc = q.shape[0], c.shape[0]
    out = torch.full((nq,), math.inf, dtype=torch.float32, device=q.device)
    for i in range(0, nq, q_chunk):
        qb = q[i : i + q_chunk]
        best = out[i : i + q_chunk]
        for j in range(0, nc, c_chunk):
            cb = c[j : j + c_chunk]
            dx = qb[:, None, 0] - cb[None, :, 0]
            dy = qb[:, None, 1] - cb[None, :, 1]
            dz = qb[:, None, 2] - cb[None, :, 2]
            d = ((dx * dx).double() + dy.double() * dy.double()).float()
            d = (d.double() + dz.double() * dz.double()).float()
            torch.minimum(best, d.amin(1), out=best)
    return out


def _check(q: torch.Tensor, c: torch.Tensor) -> None:
    for name, t in (("q", q), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must have shape (N, 3), got {tuple(t.shape)}")
    if q.device != c.device:
        raise ValueError(f"q on {q.device} and c on {c.device} must share a device")


def nn_min_sq(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(Q, 3) x (C, 3) f32 -> (Q,) f32: each query's squared distance to its
    nearest corpus point (+inf when C is 0)."""
    _check(q, c)
    if q.device.type == "cpu":
        return min_sq_reference(q, c)
    if not q.is_cuda:
        raise ValueError(f"nn_min_sq runs on CUDA or CPU tensors, got {q.device}")
    if not (q.is_contiguous() and c.is_contiguous()):
        raise ValueError("q and c must be contiguous")
    nq, nc = q.shape[0], c.shape[0]
    out = torch.full((nq,), math.inf, dtype=torch.float32, device=q.device)
    if nq and nc:
        lib = cuda_build.library("nn_dist")
        with torch.cuda.device(q.device):
            sms = torch.cuda.get_device_properties(q.device).multi_processor_count
            qpt, chunk = launch_plan(nq, nc, sms)
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = lib.lfr_nn_min_sq(q.data_ptr(), c.data_ptr(), nq, nc, out.data_ptr(),
                                     qpt, chunk, stream)
        cuda_build.check(lib, code, "lfr_nn_min_sq")
        LAUNCHES["nn_dist"] += 1
    return out


def min_dists(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(Q,) f32 distance of each query to its nearest corpus point."""
    return torch.sqrt(nn_min_sq(q, c))


def count_within(q: torch.Tensor, c: torch.Tensor, tolerances: Sequence[float]) -> np.ndarray:
    """(T,) int64 counts of queries whose squared nearest distance is at
    most tol^2 (tol^2 squared in f32 on the host, as the JAX package does);
    only the T counts leave the device."""
    tol2 = torch.from_numpy(np.square(np.asarray(tolerances, np.float32))).to(q.device)
    d2 = nn_min_sq(q, c)
    counts = torch.stack([(d2 <= t).sum() for t in tol2]) if len(tol2) else tol2.long()
    return counts.cpu().numpy().astype(np.int64)
