"""Correlation volume of the flow CNN: CUDA kernels and their plain version.

For a patch pair with per-position L2-normalised feature maps fr, ft of
shape (289, 128) (17 x 17 positions, index h*17+w):

    c      = fr @ ft^T                  f32 accumulation
    corr12 = rownorm(relu(c))           rows: reference positions
    corr21 = rownorm(relu(ft @ fr^T))   sym variant only

with rownorm(x) = x / max(||x||, 1e-12) over the 289-wide row.

Kernels (``csrc/correlation.cu``, built by nvcc for sm_90a, see
``cuda_build``) replace the Pallas TPU kernels of lfr_tpu/ops/correlation.py:
``lfr_corr_asym`` replaces ``_kernel_asym`` (:102) and ``lfr_corr_sym``
replaces ``_kernel_sym`` (:93).  Two more replace the variants that
scripts/bench_corr_variants.py launches to split the asym kernel's cost:
``lfr_corr_nonorm`` (``kernel_nonorm``, :59: relu(fr @ ft^T), no norm) and
``lfr_corr_matmul`` (``kernel_matmul_only``, :64: fr @ ft^T).  All are bound
by memory traffic, not arithmetic: at B = 4096 each asym-shaped kernel reads
606 MB and writes 684 MB (0.385 ms at 3.35 TB/s) against 87.6 GFLOP
(0.089 ms at 989 TFLOP/s bf16).  One template serves all four: persistent
blocks walk the pairs, TMA loads the next maps while the current ones
multiply, the f32 products stay in registers through ReLU and the row norm,
and each 64-row span of the bf16 output leaves in 16-byte stores; the
source says how.

The wrappers take bf16 (B, 289, 128) contiguous, 16-byte-aligned CUDA
tensors (the tensor maps of the loads need the alignment) and return bf16
volumes.  A tensor on the CPU goes to the plain version,
:func:`correlation_reference` (f32 out, as the JAX fallback); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_build

#: Feature-map positions (17 * 17) and channels.
POS = 289
CHANNELS = 128

#: Kernel launches per variant, counted where the kernel is launched.
LAUNCHES = {"corr_sym": 0, "corr_asym": 0, "corr_nonorm": 0, "corr_matmul": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _norm_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


def _corr(f_ref: torch.Tensor, f_tgt: torch.Tensor) -> torch.Tensor:
    """Plain version of ``lfr_corr_matmul``: fr @ ft^T in f32."""
    return torch.einsum("bpc,bqc->bpq", f_ref.float(), f_tgt.float())


def _relu_corr(f_ref: torch.Tensor, f_tgt: torch.Tensor) -> torch.Tensor:
    """Plain version of ``lfr_corr_nonorm``: relu(fr @ ft^T) in f32."""
    return _corr(f_ref, f_tgt).relu()


def correlation_reference(f_ref: torch.Tensor, f_tgt: torch.Tensor, sym: bool = True):
    """Plain version: (B, P, C) x2 -> (corr12, corr21), each (B, P, P) f32,
    or corr12 alone when not ``sym``."""
    c = _relu_corr(f_ref, f_tgt)
    if not sym:
        return _norm_rows(c)
    return _norm_rows(c), _norm_rows(c.transpose(1, 2))


def _check_kernel_inputs(f_ref: torch.Tensor, f_tgt: torch.Tensor) -> None:
    for name, t in (("f_ref", f_ref), ("f_tgt", f_tgt)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if t.dim() != 3 or tuple(t.shape[1:]) != (POS, CHANNELS):
            raise ValueError(f"{name} must have shape (B, {POS}, {CHANNELS}), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if f_ref.shape != f_tgt.shape or f_ref.device != f_tgt.device:
        raise ValueError(
            f"f_ref {tuple(f_ref.shape)} on {f_ref.device} and f_tgt "
            f"{tuple(f_tgt.shape)} on {f_tgt.device} must match"
        )
    for name, t in (("f_ref", f_ref), ("f_tgt", f_tgt)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


#: Device indices on which the kernels have their shared memory opted in.
_READY = set()


def _launch(entry: str, b: int, *tensors: torch.Tensor) -> None:
    """Run C entry point ``entry`` on the tensors' device and current stream.
    ``torch.cuda.device`` makes that device current for the call and then
    restores the caller's."""
    device = tensors[0].device
    lib = cuda_build.library()
    with torch.cuda.device(device):
        if device.index not in _READY:
            cuda_build.check(lib, lib.lfr_corr_init(), "lfr_corr_init")
            _READY.add(device.index)
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(*(t.data_ptr() for t in tensors), b, stream)
    cuda_build.check(lib, code, entry)


def _single_view(entry: str, key: str, f_ref: torch.Tensor, f_tgt: torch.Tensor):
    """One (B, 289, 289) bf16 volume from C entry point ``entry``."""
    _check_kernel_inputs(f_ref, f_tgt)
    b = f_ref.shape[0]
    out = torch.empty((b, POS, POS), dtype=torch.bfloat16, device=f_ref.device)
    if b:
        _launch(entry, b, f_ref, f_tgt, out)
        LAUNCHES[key] += 1
    return out


def correlation_asym(f_ref: torch.Tensor, f_tgt: torch.Tensor) -> torch.Tensor:
    """corr12 only: (B, 289, 128) x2 -> (B, 289, 289)."""
    if _on_cpu(f_ref, f_tgt):
        return correlation_reference(f_ref, f_tgt, sym=False)
    return _single_view("lfr_corr_asym", "corr_asym", f_ref, f_tgt)


def correlation_sym(
    f_ref: torch.Tensor, f_tgt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corr12, corr21): (B, 289, 128) x2 -> 2 x (B, 289, 289), one launch."""
    if _on_cpu(f_ref, f_tgt):
        return correlation_reference(f_ref, f_tgt)
    _check_kernel_inputs(f_ref, f_tgt)
    b = f_ref.shape[0]
    c12 = torch.empty((b, POS, POS), dtype=torch.bfloat16, device=f_ref.device)
    c21 = torch.empty_like(c12)
    if b:
        _launch("lfr_corr_sym", b, f_ref, f_tgt, c12, c21)
        LAUNCHES["corr_sym"] += 1
    return c12, c21


def correlation_nonorm(f_ref: torch.Tensor, f_tgt: torch.Tensor) -> torch.Tensor:
    """relu(fr @ ft^T) without the row norm: (B, 289, 128) x2 -> (B, 289, 289)."""
    if _on_cpu(f_ref, f_tgt):
        return _relu_corr(f_ref, f_tgt)
    return _single_view("lfr_corr_nonorm", "corr_nonorm", f_ref, f_tgt)


def correlation_matmul(f_ref: torch.Tensor, f_tgt: torch.Tensor) -> torch.Tensor:
    """fr @ ft^T alone: (B, 289, 128) x2 -> (B, 289, 289)."""
    if _on_cpu(f_ref, f_tgt):
        return _corr(f_ref, f_tgt)
    return _single_view("lfr_corr_matmul", "corr_matmul", f_ref, f_tgt)


def corr_views(f_ref: torch.Tensor, f_tgt: torch.Tensor, sym: bool = True):
    """Normalised correlation view(s): corr12, or (corr12, corr21) if sym."""
    return correlation_sym(f_ref, f_tgt) if sym else correlation_asym(f_ref, f_tgt)
