"""Geometric verification: batched F + H RANSAC on the device (port of
lfr_tpu/sfm/verify.py).

Replaces ``colmap matches_importer``: for each image pair, NUM_HYPOTHESES
fundamental and homography hypotheses from minimal samples are scored at
once, the best of each is refit four times on its inlier set (a refit is
taken only if it keeps at least as many inliers), and the pair is
classified as COLMAP does (planar when H explains at least 0.8 of F's
inliers).  Pairs run batched: (pairs x hypotheses x matches) tensors.

Samples.  The RANSAC functions take their sample indices as an argument.
:class:`BatchedVerifier` draws them on the host with a CPU
``torch.Generator`` seeded from (seed, pair index), so they depend neither
on the batching nor on the device: a card run and a CPU run score the same
hypotheses.  (JAX draws with ``jax.random.choice``, a stream torch cannot
reproduce; the tests feed both the JAX package's own indices.)

Padding.  A pair's correspondences are zero-padded to a multiple of
MATCH_BUCKET rows, as the JAX package pads them, and the refits' Hartley
normalization averages over the padded rows too (the reference does so),
so the padding is part of the result; pairs are batched by padded size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import geometry

#: COLMAP two-view-geometry configurations (public COLMAP convention).
CONFIG_DEGENERATE = 1
CONFIG_CALIBRATED = 2
CONFIG_UNCALIBRATED = 3
CONFIG_PLANAR_OR_PANORAMIC = 6

#: Defaults mirroring COLMAP's TwoViewGeometryOptions.
MAX_ERROR_PX = 4.0
MIN_NUM_INLIERS = 15
NUM_HYPOTHESES = 256
MATCH_BUCKET = 512

#: Guarded refit rounds after the hypothesis stage.
REFIT_ROUNDS = 4

#: Pairs per device batch times their padded match count: keeps the
#: (pairs, hypotheses, matches) score tensors near 2**24 elements.
BATCH_MATCHES = 65536


def _ransac(x1, x2, valid, idx, minimal, error, max_error):
    """Shared body of the F and H RANSAC: hypotheses from the samples
    ``idx`` (..., S, k) by ``minimal``, scored by ``error``; the best one
    refit REFIT_ROUNDS times, each refit kept only if it loses no inliers.
    Returns (model (..., 3, 3), inliers (..., N), count (...))."""
    thr = max_error**2
    # int64: torch's gather misreads an expanded int32 index (torch 2.13).
    rows = idx.long().flatten(-2)[..., None].expand(*idx.shape[:-2], -1, 2)
    s1 = torch.gather(x1, -2, rows).unflatten(-2, idx.shape[-2:])
    s2 = torch.gather(x2, -2, rows).unflatten(-2, idx.shape[-2:])
    models = minimal(s1, s2)  # (..., S, 3, 3)
    # A sample that repeats a correspondence is degenerate: its exact system
    # is singular, but the LU's rounding decides whether it comes out NaN or
    # as an arbitrary member of the sample's model family (JAX's CPU LU: NaN
    # for 96 of 255 such samples).  Every such hypothesis scores 0 here, on
    # every device.
    repeats = (idx.sort(dim=-1).values.diff(dim=-1) == 0).any(-1)
    models = torch.where(repeats[..., None, None], torch.nan, models)
    valid_h = valid[..., None, :]
    scores = ((error(models, x1[..., None, :, :], x2[..., None, :, :]) <= thr) & valid_h).sum(-1)
    best = scores.argmax(dim=-1)  # the first maximal score, as jnp.argmax
    n_best = torch.gather(scores, -1, best[..., None])[..., 0]
    model = torch.gather(models, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[
        ..., 0, :, :]
    for _ in range(REFIT_ROUNDS):
        w = ((error(model, x1, x2) <= thr) & valid).to(x1.dtype)
        refit = minimal(x1, x2, w)
        n2 = ((error(refit, x1, x2) <= thr) & valid).sum(-1)
        take = n2 >= n_best
        model = torch.where(take[..., None, None], refit, model)
        n_best = torch.maximum(n2, n_best)
    inliers = (error(model, x1, x2) <= thr) & valid
    return model, inliers, inliers.sum(-1)


def _fundamental(s1, s2, w=None):
    return geometry.fundamental_8point(s1, s2, w, fast=w is None)


def _homography(s1, s2, w=None):
    return geometry.homography_dlt(s1, s2, fast=w is None, w=w)


def ransac_fundamental(x1, x2, valid, idx, max_error=MAX_ERROR_PX):
    """F RANSAC for (..., N, 2) padded correspondences with (..., N) mask
    ``valid`` and (..., S, 8) sample indices.  ``max_error``: Sampson
    threshold in the units of x.  Returns (F, inlier mask, inlier count)."""
    return _ransac(x1, x2, valid, idx, _fundamental, geometry.sampson_error, max_error)


def ransac_homography(x1, x2, valid, idx, max_error=MAX_ERROR_PX):
    """H RANSAC as :func:`ransac_fundamental`, with (..., S, 4) samples and
    the transfer error."""
    return _ransac(x1, x2, valid, idx, _homography, geometry.homography_error, max_error)


def verify_batch(x1, x2, valid, idx_f, idx_h):
    """F and H RANSAC for a batch of pairs, packed into one (B, 20 + 2N)
    float32 tensor [n_F, n_H, F (9), H (9), inl_F (N), inl_H (N)] so the
    batch costs one read-back."""
    F, inl_f, n_f = ransac_fundamental(x1, x2, valid, idx_f)
    H, inl_h, n_h = ransac_homography(x1, x2, valid, idx_h)
    return torch.cat(
        [
            torch.stack([n_f, n_h], dim=-1).float(),
            F.flatten(-2).float(),
            H.flatten(-2).float(),
            inl_f.float(),
            inl_h.float(),
        ],
        dim=-1,
    )


@dataclasses.dataclass
class TwoViewGeometry:
    inlier_matches: np.ndarray  # (K, 2) feature index pairs
    config: int
    F: np.ndarray
    H: Optional[np.ndarray] = None


def _pad_points(x: np.ndarray, bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    n = x.shape[0]
    target = max(bucket, -(-n // bucket) * bucket)
    out = np.zeros((target, 2), np.float32)
    out[:n] = x
    valid = np.zeros(target, bool)
    valid[:n] = True
    return out, valid


def sample_indices(seed: int, index: int, n_valid: int, n_padded: int):
    """The pair's minimal samples, (NUM_HYPOTHESES, 8) for F and
    (NUM_HYPOTHESES, 4) for H, drawn with replacement from its ``n_valid``
    correspondences by a CPU generator seeded from (seed, index)."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(state))
    probs = torch.zeros(n_padded)
    probs[:n_valid] = 1.0 / n_valid
    idx_f = torch.multinomial(probs, NUM_HYPOTHESES * 8, replacement=True, generator=g)
    idx_h = torch.multinomial(probs, NUM_HYPOTHESES * 4, replacement=True, generator=g)
    return idx_f.view(NUM_HYPOTHESES, 8), idx_h.view(NUM_HYPOTHESES, 4)


def _batch_rows_for(n_padded: int) -> int:
    return max(8, BATCH_MATCHES // max(n_padded, 1))


def _upload(arrays, dev: torch.device):
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if dev.type == "cuda":
        return [t.pin_memory().to(dev, non_blocking=True) for t in tensors]
    return tensors


def _degenerate() -> TwoViewGeometry:
    return TwoViewGeometry(np.zeros((0, 2), np.uint32), CONFIG_DEGENERATE, np.eye(3))


class BatchedVerifier:
    """Accumulate pairs and verify them in device batches grouped by padded
    size.

    ``add()`` queues a pair (pairs with < 8 matches resolve at once as
    degenerate); results come out of ``ready()`` / ``flush()`` as (token,
    TwoViewGeometry), unordered across sizes.  At most one batch stays in
    flight, so the device's RANSAC overlaps the caller's DB writes; reading
    a batch back is its only host sync.  ``counters`` counts dispatched
    ``batches`` and verified ``pairs``.
    """

    def __init__(self, seed: int = 0, min_num_inliers: int = MIN_NUM_INLIERS, device="cuda"):
        self.device = resolve_device(device)
        self._seed = seed
        self._n_added = 0
        self._min_inliers = min_num_inliers
        #: padded n -> list of (token, matches, x1p, x2p, valid, idx_f, idx_h)
        self._acc = {}
        #: in flight: list of (device tensor, [(token, matches), ...])
        self._inflight = []
        self._done = []
        self.counters = {"batches": 0, "pairs": 0}

    def add(self, token, keypoints1, keypoints2, matches) -> None:
        i = self._n_added
        self._n_added += 1
        if matches.shape[0] < 8:
            self._done.append((token, _degenerate()))
            return
        x1 = keypoints1[matches[:, 0], :2].astype(np.float32)
        x2 = keypoints2[matches[:, 1], :2].astype(np.float32)
        x1p, valid = _pad_points(x1, MATCH_BUCKET)
        x2p, _ = _pad_points(x2, MATCH_BUCKET)
        n = x1p.shape[0]
        idx_f, idx_h = sample_indices(self._seed, i, matches.shape[0], n)
        group = self._acc.setdefault(n, [])
        group.append((token, matches, x1p, x2p, valid, idx_f.numpy(), idx_h.numpy()))
        if len(group) >= _batch_rows_for(n):
            self._dispatch(n)

    def _dispatch(self, n: int) -> None:
        group = self._acc.pop(n, [])
        if not group:
            return
        arrays = [np.stack([g[k] for g in group]) for k in range(2, 7)]
        packed = verify_batch(*_upload(arrays, self.device))
        self._inflight.append((packed, [(g[0], g[1]) for g in group]))
        self.counters["batches"] += 1
        self.counters["pairs"] += len(group)
        while len(self._inflight) > 1:
            self._collect_one()

    def _collect_one(self) -> None:
        packed, metas = self._inflight.pop(0)
        rows = packed.cpu().numpy()  # the batch's one read-back
        for row, (token, matches) in zip(rows, metas):
            self._done.append((token, _classify_packed(row, matches, self._min_inliers)))

    def ready(self):
        out, self._done = self._done, []
        return out

    def flush(self):
        for n in list(self._acc):
            self._dispatch(n)
        while self._inflight:
            self._collect_one()
        return self.ready()


def _classify_packed(
    packed: np.ndarray, matches: np.ndarray, min_num_inliers: int
) -> TwoViewGeometry:
    """Classify one packed verify row (COLMAP-style planarity test)."""
    n_F = int(packed[0])
    n_H = int(packed[1])
    F = packed[2:11].reshape(3, 3).astype(np.float64)
    H = packed[11:20].reshape(3, 3).astype(np.float64)
    n = (packed.shape[0] - 20) // 2
    inl_F = packed[20 : 20 + n] > 0
    inl_H = packed[20 + n :] > 0

    if n_F < min_num_inliers:
        return TwoViewGeometry(np.zeros((0, 2), np.uint32), CONFIG_DEGENERATE, F)
    if n_H >= 0.8 * n_F:
        mask = inl_H[: matches.shape[0]]
        config = CONFIG_PLANAR_OR_PANORAMIC
    else:
        mask = inl_F[: matches.shape[0]]
        config = CONFIG_UNCALIBRATED
    return TwoViewGeometry(matches[mask].astype(np.uint32), config, F, H)


def verify_pair(
    keypoints1: np.ndarray,
    keypoints2: np.ndarray,
    matches: np.ndarray,
    seed: int = 0,
    min_num_inliers: int = MIN_NUM_INLIERS,
    device="cuda",
) -> TwoViewGeometry:
    """Epipolar verification of one pair's putative matches (the pair's
    samples are those of index 0 under ``seed``)."""
    verifier = BatchedVerifier(seed, min_num_inliers, device)
    verifier.add(None, keypoints1, keypoints2, matches)
    return verifier.flush()[0][1]
