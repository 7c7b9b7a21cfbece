"""Mutual-nearest-neighbour descriptor matchers (port of lfr_tpu/ops/matchers.py).

Mutual nearest neighbour with either a similarity threshold or a symmetric
Lowe ratio test on L2-normalised descriptors, including the reference's
1e-8 ratio epsilon.  Descriptor counts are padded to buckets and the padded
rows and columns take the similarity ``_PAD_SIM``, so a pair matches exactly
as it does in the JAX package, and a stack of pairs matches in one batched
product.  Argmax ties go to the first index (``torch.argmax``, as
``jnp.argmax``).  The similarity product runs in strict f32: a TF32
product rounds the mantissa to 10 bits, which flips near-tied matches.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

#: Descriptor counts are padded to multiples of this.
BUCKET = 256

#: Similarity of padded rows and columns; real similarities of unit
#: descriptors lie in [-1, 1].
_PAD_SIM = -2.0


@contextlib.contextmanager
def strict_f32():
    """Run f32 matrix products and cuDNN convolutions without TF32 inside
    the block, whatever the caller's settings; they are restored on exit."""
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def _pad_descriptors(d: np.ndarray, dim_bucket: int = 8) -> Tuple[np.ndarray, int]:
    n, dim = d.shape
    n_pad = -(-max(n, 1) // BUCKET) * BUCKET
    dim_pad = -(-dim // dim_bucket) * dim_bucket
    out = np.zeros((n_pad, dim_pad), dtype=np.float32)
    out[:n, :dim] = d
    return out, n


def _masked_similarity(d1, d2, n1, n2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., B1, D) x (..., B2, D) -> (sim (..., B1, B2) with padding at
    ``_PAD_SIM``, valid1 (..., B1)); n1, n2 broadcast over the leading axes."""
    with strict_f32():
        sim = torch.matmul(d1, d2.transpose(-1, -2))
    n1 = torch.as_tensor(n1, device=sim.device)[..., None]
    n2 = torch.as_tensor(n2, device=sim.device)[..., None]
    valid1 = torch.arange(sim.shape[-2], device=sim.device) < n1
    valid2 = torch.arange(sim.shape[-1], device=sim.device) < n2
    mask = valid1[..., :, None] & valid2[..., None, :]
    return torch.where(mask, sim, torch.full_like(sim, _PAD_SIM)), valid1


def _mutual(nn12: torch.Tensor, nn21: torch.Tensor) -> torch.Tensor:
    ids1 = torch.arange(nn12.shape[-1], device=nn12.device)
    return ids1 == torch.gather(nn21, -1, nn12)


def _mnn_similarity_padded(d1, d2, n1, n2, threshold):
    """Mutual NN with a similarity threshold -> (nn12, match_sim, keep), each (..., B1)."""
    sim, valid1 = _masked_similarity(d1, d2, n1, n2)
    nn12 = torch.argmax(sim, dim=-1)
    match_sim = torch.amax(sim, dim=-1)
    nn21 = torch.argmax(sim, dim=-2)
    threshold = torch.as_tensor(threshold, dtype=sim.dtype, device=sim.device)[..., None]
    keep = _mutual(nn12, nn21) & (match_sim >= threshold) & valid1
    return nn12, match_sim, keep


def _top2(sim: torch.Tensor, dim: int):
    """(best, second best, argbest) along ``dim`` as masked max passes."""
    a1 = torch.argmax(sim, dim=dim)
    m1 = torch.amax(sim, dim=dim)
    shape = [1] * sim.dim()
    shape[dim] = -1
    pos = torch.arange(sim.shape[dim], device=sim.device).view(shape)
    hit = pos == a1.unsqueeze(dim)
    m2 = torch.amax(torch.where(hit, torch.full_like(sim, _PAD_SIM), sim), dim=dim)
    return m1, m2, a1


def _ratios(best: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    dist = torch.sqrt(torch.clamp_min(2.0 - 2.0 * torch.stack([best, second], -1), 0.0))
    return dist[..., 0] / (dist[..., 1] + 1e-8)


def _mnn_ratio_padded(d1, d2, n1, n2, ratio):
    """Mutual NN with the symmetric ratio test -> (nn12, match_sim, keep)."""
    sim, valid1 = _masked_similarity(d1, d2, n1, n2)
    sim12_1, sim12_2, nn12 = _top2(sim, dim=-1)
    ratios12 = _ratios(sim12_1, sim12_2)
    sim21_1, sim21_2, nn21 = _top2(sim, dim=-2)
    ratios21 = _ratios(sim21_1, sim21_2)
    ratio = torch.as_tensor(ratio, dtype=sim.dtype, device=sim.device)[..., None]
    keep = (
        _mutual(nn12, nn21)
        & (ratios12 <= ratio)
        & (torch.gather(ratios21, -1, nn12) <= ratio)
        & valid1
    )
    return nn12, sim12_1, keep


def match_padded(d1, d2, n1, n2, threshold, matcher: str):
    """Dispatch to the padded matcher of kind ``matcher``."""
    if matcher == "similarity":
        return _mnn_similarity_padded(d1, d2, n1, n2, threshold)
    if matcher == "ratio":
        return _mnn_ratio_padded(d1, d2, n1, n2, threshold)
    raise NotImplementedError(f"unknown matcher {matcher!r}")


def decision_margin(d1: np.ndarray, d2: np.ndarray, i: int, j: int, threshold: float) -> float:
    """How near match (i, j) of descriptors d1, d2 sits to a decision of the
    matchers: the smallest of the top-2 similarity gaps of row i and column
    j, and of the distances of their ratios from ``threshold``.  Two f32
    summation orders may decide a match differently only where this is
    about the products' rounding (~1e-7)."""
    row = np.sort(d2 @ d1[i])[-2:]
    col = np.sort(d1 @ d2[j])[-2:]
    margins = [row[1] - row[0], col[1] - col[0]]
    for best, second in (row[::-1], col[::-1]):
        dist = np.sqrt(np.maximum(2.0 - 2.0 * np.array([best, second]), 0.0))
        margins.append(abs(dist[0] / (dist[1] + 1e-8) - threshold))
    return float(min(margins))


def _finalize(nn12, match_sim, keep, n1) -> Tuple[np.ndarray, np.ndarray]:
    nn12 = nn12.cpu().numpy()[:n1]
    match_sim = match_sim.cpu().numpy()[:n1]
    keep = keep.cpu().numpy()[:n1]
    ids1 = np.nonzero(keep)[0]
    matches = np.stack([ids1, nn12[ids1]], axis=-1).astype(np.int64)
    return matches, match_sim[ids1]


def _match(descriptors1, descriptors2, threshold, matcher, device):
    if descriptors1.shape[0] == 0 or descriptors2.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.int64), np.zeros(0, dtype=np.float32)
    dev = resolve_device(device)
    d1, n1 = _pad_descriptors(np.asarray(descriptors1, dtype=np.float32))
    d2, n2 = _pad_descriptors(np.asarray(descriptors2, dtype=np.float32))
    out = match_padded(
        torch.from_numpy(d1).to(dev), torch.from_numpy(d2).to(dev), n1, n2,
        float(threshold), matcher,
    )
    return _finalize(*out, n1)


def mnn_similarity_matcher(
    descriptors1: np.ndarray, descriptors2: np.ndarray, threshold: float = 0.8, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Mutual-NN + similarity threshold. Returns (matches (N,2), sims (N,))."""
    return _match(descriptors1, descriptors2, threshold, "similarity", device)


def mnn_ratio_matcher(
    descriptors1: np.ndarray, descriptors2: np.ndarray, ratio: float = 0.8, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Mutual-NN + symmetric Lowe ratio test. Returns (matches (N,2), sims (N,))."""
    return _match(descriptors1, descriptors2, ratio, "ratio", device)


def match(
    descriptors1: np.ndarray,
    descriptors2: np.ndarray,
    matcher: str,
    threshold: float,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatch by matcher kind ("similarity" or "ratio")."""
    if matcher not in ("similarity", "ratio"):
        raise NotImplementedError(f"unknown matcher {matcher!r}")
    return _match(descriptors1, descriptors2, threshold, matcher, device)
