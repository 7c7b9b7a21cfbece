"""Absolute camera pose from 2D-3D correspondences (PnP): batched RANSAC in
torch on the device (port of lfr_tpu/sfm/pnp.py).

Used by the incremental mapper to register images.  NUM_HYPOTHESES poses
come from 6-point DLTs of the projection matrix, are scored at once, and the
best is polished by a guarded Gauss-Newton on its inliers.

Samples.  :func:`ransac_pnp` takes its (NUM_HYPOTHESES, 6) sample indices
as an argument; :func:`sample_indices` draws them with a CPU
``torch.Generator``, so a card run and a CPU run score the same hypotheses.
(JAX draws with ``jax.random.choice``, which torch cannot reproduce; the
tests feed both packages JAX's indices.)

Differences from the JAX package by design:

- the DLT's null vector has an arbitrary sign.  JAX orthogonalises P[:, :3]
  as it comes out of the SVD, which gives the right pose only when P has
  the positive scale: with -P it returns a matrix of determinant -1 and a
  wrong translation, and the hypothesis scores near 0.  Here P is negated
  where det(P[:, :3]) < 0 first, so every exact sample gives its pose;
- a sample that repeats a correspondence (sampling is with replacement) is
  singular and scores 0, as in :mod:`.verify`;
- the polish's Jacobian is written in closed form (JAX: ``jacfwd``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.matchers import strict_f32
from . import geometry
from .ba import skew, so3_exp

MAX_ERROR_PX = 8.0
NUM_HYPOTHESES = 256
MIN_INLIERS = 10

#: Guarded Gauss-Newton steps after the hypothesis stage.
POLISH_STEPS = 5


def pose_from_dlt(X: torch.Tensor, uv: torch.Tensor):
    """(R, t) from (..., K, 3) world points and (..., K, 2) normalized image
    coordinates, K >= 6: the DLT's projection matrix P with the sign that
    makes det(P[:, :3]) positive, its closest rotation, the translation
    divided by the mean singular value, and the sign that puts the
    centroid in front of the camera."""
    ones = torch.ones_like(X[..., :1])
    Xh = torch.cat([X, ones], -1)
    z = torch.zeros_like(Xh)
    rows1 = torch.cat([Xh, z, -uv[..., 0:1] * Xh], -1)
    rows2 = torch.cat([z, Xh, -uv[..., 1:2] * Xh], -1)
    A = torch.cat([rows1, rows2], -2)  # (..., 2K, 12)
    P = geometry.smallest_right_vector(A).unflatten(-1, (3, 4))
    P = P * torch.where(torch.linalg.det(P[..., :3]) < 0, -1.0, 1.0)[..., None, None]
    # A non-finite P (a degenerate sample) must not reach the SVD, which
    # raises on it: orthogonalise the identity there and return NaN.
    bad = ~torch.isfinite(P).all(-1).all(-1)
    eye = torch.eye(3, dtype=P.dtype, device=P.device)
    M = torch.where(bad[..., None, None], eye, P[..., :3])
    u, s, vt = torch.linalg.svd(M)
    det = torch.linalg.det(u @ vt)
    sign = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (u * sign[..., None, :]) @ vt
    scale = (s * sign).sum(-1) / 3.0
    t = P[..., 3] / torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12), scale)[..., None]
    centroid = X.mean(-2)
    depth = (R[..., 2, :] * centroid).sum(-1) + t[..., 2]
    flip = torch.where(bad, torch.nan, torch.sign(depth))
    return R * flip[..., None, None], t * flip[..., None]


def reproj_err_sq(R, t, X, uv, focal):
    """Squared reprojection errors (px^2) of (..., N) correspondences under
    poses (..., 3, 3), (..., 3); inf behind the camera."""
    with strict_f32():
        c = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.where(c[..., 2:].abs() < 1e-9, torch.full_like(c[..., 2:], 1e-9), c[..., 2:])
    proj = c[..., :2] / z
    err = ((proj - uv) ** 2).sum(-1) * focal**2
    return torch.where(c[..., 2] > 0, err, torch.full_like(err, float("inf")))


def _polish_step(R, t, X, uv, valid, focal, thr):
    """One Gauss-Newton step on the inliers of (R, t): the residual
    (proj - uv) * w * focal with w the inlier mask, its 2x6 Jacobian over
    [rotation increment, translation] in closed form (c = exp(dw) R X + t +
    dt: d c / d dw = -[R X]x), and the 6x6 solve with 1e-6 damping."""
    w = ((reproj_err_sq(R, t, X, uv, focal) <= thr) & valid).to(X.dtype)
    with strict_f32():
        p = X @ R.T
    c = p + t
    tiny = c[:, 2].abs() < 1e-9
    zc = torch.where(tiny, torch.full_like(c[:, 2], 1e-9), c[:, 2])
    proj = c[:, :2] / zc[:, None]
    scale = (w * focal)[:, None]
    r = ((proj - uv) * scale).reshape(-1)
    inv = 1.0 / zc
    dz = torch.where(tiny[:, None], torch.zeros_like(proj), -proj / zc[:, None])
    zero = torch.zeros_like(inv)
    dproj = torch.stack(
        [torch.stack([inv, zero, dz[:, 0]], -1), torch.stack([zero, inv, dz[:, 1]], -1)], -2
    )
    dcam = torch.cat([-skew(p), torch.eye(3, dtype=X.dtype, device=X.device).expand(len(p), 3, 3)], -1)
    with strict_f32():
        J = ((dproj @ dcam) * scale[..., None]).reshape(-1, 6)
        H = J.T @ J + 1e-6 * torch.eye(6, dtype=X.dtype, device=X.device)
        g = J.T @ r
    delta = torch.linalg.solve_ex(H, -g[:, None], check_errors=False)[0][:, 0]
    with strict_f32():
        R2 = so3_exp(delta[:3]) @ R
    return R2, t + delta[3:]


def ransac_pnp(X, uv, valid, focal, idx):
    """RANSAC PnP over padded (N, 3) / (N, 2) correspondences with (N,) mask
    ``valid`` and per-row ``focal``, from the (S, 6) sample indices ``idx``.
    Returns (R, t, inlier mask (N,), inlier count), all on X's device."""
    thr = MAX_ERROR_PX**2
    Rs, ts = pose_from_dlt(X[idx], uv[idx])
    repeats = (idx.sort(dim=-1).values.diff(dim=-1) == 0).any(-1)
    Rs = torch.where(repeats[:, None, None], torch.nan, Rs)
    ts = torch.where(repeats[:, None], torch.nan, ts)
    scores = ((reproj_err_sq(Rs, ts, X, uv, focal) <= thr) & valid).sum(-1)
    best = scores.argmax()  # the first maximal score, as jnp.argmax
    R, t, n_best = Rs[best], ts[best], scores[best]
    for _ in range(POLISH_STEPS):
        R2, t2 = _polish_step(R, t, X, uv, valid, focal, thr)
        n2 = ((reproj_err_sq(R2, t2, X, uv, focal) <= thr) & valid).sum()
        take = n2 >= n_best
        R = torch.where(take, R2, R)
        t = torch.where(take, t2, t)
        n_best = torch.maximum(n2, n_best)
    inliers = (reproj_err_sq(R, t, X, uv, focal) <= thr) & valid
    return R, t, inliers, inliers.sum()


def sample_indices(seed: int, n_valid: int, n_padded: int) -> torch.Tensor:
    """(NUM_HYPOTHESES, 6) sample indices drawn with replacement from the
    first ``n_valid`` of ``n_padded`` rows by a CPU generator seeded from
    (seed, n_valid, n_padded): the same on every device and every call."""
    state = np.random.SeedSequence([seed, n_valid, n_padded]).generate_state(1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(state))
    probs = torch.zeros(n_padded)
    probs[:n_valid] = 1.0 / n_valid
    idx = torch.multinomial(probs, NUM_HYPOTHESES * 6, replacement=True, generator=g)
    return idx.view(NUM_HYPOTHESES, 6)


def bucket_size(n: int) -> int:
    """The padded row count of ``n`` correspondences, as the JAX package
    pads them (a power of two, at least 64)."""
    return max(64, 1 << (n - 1).bit_length())


def estimate_pose(
    points3D: np.ndarray,
    uv_normalized: np.ndarray,
    focal: float,
    seed: int = 0,
    min_inliers: int = MIN_INLIERS,
    device="cuda",
    samples=None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """RANSAC PnP; returns (R, t, inlier_mask) as numpy arrays, or None.

    ``samples``: optional (NUM_HYPOTHESES, 6) indices into the padded rows;
    by default :func:`sample_indices` under ``seed``."""
    n = points3D.shape[0]
    if n < 6:
        return None
    dev = resolve_device(device)
    bucket = bucket_size(n)
    X = np.zeros((bucket, 3), np.float32)
    uv = np.zeros((bucket, 2), np.float32)
    valid = np.zeros(bucket, bool)
    X[:n] = points3D
    uv[:n] = uv_normalized
    valid[:n] = True
    if samples is None:
        samples = sample_indices(seed, n, bucket)
    R, t, inliers, count = ransac_pnp(
        torch.from_numpy(X).to(dev),
        torch.from_numpy(uv).to(dev),
        torch.from_numpy(valid).to(dev),
        torch.full((bucket,), focal, dtype=torch.float32, device=dev),
        torch.as_tensor(np.asarray(samples), dtype=torch.int64, device=dev),
    )
    if int(count) < min_inliers:
        return None
    return R.cpu().numpy(), t.cpu().numpy(), inliers.cpu().numpy()[:n]
