"""Projective geometry primitives in torch, batched over leading dims (port
of lfr_tpu/sfm/geometry.py).

Rotations, projection, DLT triangulation, fundamental / essential /
homography estimation and Sampson scoring.  Every function takes tensors
whose leading dims are batch dims (pairs, hypotheses, tracks) and returns
what the JAX function returns for each batch element.

Two places differ in method, not in result:

- the exact null vectors (the F and H refits, the DLT, the rank-2
  projection) are the smallest eigenvector of the Gram matrix ``AᵀA``,
  formed in float64 and found by inverse iteration with repeated squaring
  (:func:`smallest_eigenvector`), where JAX takes the last right singular
  vector of ``A`` in float32.  Taller-than-32 matrices have no batched SVD
  on CUDA, and ``torch.linalg.svd`` / ``eigh`` wait for the device to check
  their status; this route is batched products and ``solve_ex`` only;
- the minimal systems of :func:`nullvec_fix_last` (and the 3x3 normal
  equations of the triangulation's Gauss-Newton) go through
  ``torch.linalg.solve_ex`` with ``check_errors=False``: a singular system
  (a sample that repeats a correspondence) gives NaN, as JAX's LU does, so
  its hypothesis scores 0, with no host sync and no raise.
"""

from __future__ import annotations

import math

import torch

#: Squarings of the shifted inverse in :func:`smallest_eigenvector`: the
#: result is the inverse raised to the 2**SQUARINGS-th power, so an
#: eigenvalue ratio r between the two smallest eigenvalues leaves
#: r**1024 of the second eigenvector (1e-5 at r = 0.989).
SQUARINGS = 10

#: Shift of the Gram matrix before its inverse, relative to its trace: it
#: keeps the LU factorisation finite for an exactly rank-deficient Gram and
#: moves no eigenvector.
GRAM_SHIFT = 1e-13


def qvec_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def project(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) -> pixels (..., 2) for world-to-cam (R, t)."""
    cam = points @ R.transpose(-1, -2) + t
    uv = cam[..., :2] / cam[..., 2:3]
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    return torch.stack([uv[..., 0] * fx + cx, uv[..., 1] * fy + cy], dim=-1)


def cam_depth(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (points @ R.transpose(-1, -2) + t)[..., 2]


def projection_matrix(R: torch.Tensor, t: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """K [R|t]: (..., 3, 4)."""
    return K @ torch.cat([R, t[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Null vectors
# ---------------------------------------------------------------------------


def smallest_eigenvector(gram: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric positive
    semi-definite (..., n, n) matrices (float64 in, float64 out).

    Inverse iteration by repeated squaring: X = (G + s I)^-1 with s a
    trace-relative shift, then X <- X @ X (rescaled) SQUARINGS times, and
    the column of largest norm.  The LU's error for a nearly singular
    ``G + s I`` lies along the wanted eigenvector (the classical argument
    for inverse iteration), so the direction stays exact to about
    eps * lambda_max / lambda_second.  The sign is arbitrary, as an SVD's;
    every caller divides it out."""
    n = gram.shape[-1]
    eye = torch.eye(n, dtype=gram.dtype, device=gram.device)
    trace = gram.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    shifted = gram + (trace * GRAM_SHIFT + 1e-300) * eye
    x, _ = torch.linalg.solve_ex(shifted, eye.expand_as(shifted), check_errors=False)
    for _ in range(SQUARINGS):
        x = x / x.abs().amax(dim=(-2, -1), keepdim=True)
        x = x @ x
    col = x.norm(dim=-2).argmax(dim=-1)
    v = torch.gather(x, -1, col[..., None, None].expand(*x.shape[:-1], 1))[..., 0]
    return v / v.norm(dim=-1, keepdim=True)


def smallest_right_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of
    (..., m, n) matrices, as ``svd(A)[2][..., -1, :]`` (up to sign), for any
    m (a wide A's null vector included).  The Gram matrix is formed in
    float64; the result has A's dtype."""
    a = A.double()
    return smallest_eigenvector(a.transpose(-1, -2) @ a).to(A.dtype)


def nullvec_fix_last(A: torch.Tensor) -> torch.Tensor:
    """Null vector of MINIMAL (..., 8, 9) design matrices by fixing the last
    component to 1 and solving ``A[..., :8] g = -A[..., 8]`` (batched LU).

    A singular system (a sample that repeats a correspondence) gives NaN, as
    JAX's ``jnp.linalg.solve`` does; the hypothesis then scores 0."""
    g, info = torch.linalg.solve_ex(A[..., :8, :8], -A[..., :8, 8:9], check_errors=False)
    g = torch.where((info != 0)[..., None, None], torch.nan, g)[..., 0]
    v = torch.cat([g, torch.ones_like(g[..., :1])], dim=-1)
    return v / v.norm(dim=-1, keepdim=True).clamp_min(1e-30)


# ---------------------------------------------------------------------------
# Triangulation
# ---------------------------------------------------------------------------


def triangulate_dlt(P: torch.Tensor, uv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multi-view DLT triangulation.

    P: (..., V, 3, 4) projection matrices; uv: (..., V, 2) observations;
    mask: (..., V) validity.  Returns (..., 3) world points (least-squares
    homogeneous solution)."""
    r0 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    m = mask.to(P.dtype)[..., None]
    A = torch.cat([r0 * m, r1 * m], dim=-2)  # (..., 2V, 4)
    X = smallest_right_vector(A)
    w = X[..., 3:4]
    return X[..., :3] / torch.where(w.abs() < 1e-12, torch.sign(w) + 1e-12, w)


# ---------------------------------------------------------------------------
# Fundamental / essential / homography estimation
# ---------------------------------------------------------------------------


def _normalize_points(x: torch.Tensor):
    """Hartley normalization over every row given, padding rows included
    (the reference's refits pass padded arrays): x (..., N, 2) ->
    (x_norm, T (..., 3, 3))."""
    mean = x.mean(dim=-2, keepdim=True)
    d = ((x - mean) ** 2).sum(-1).sqrt()
    scale = math.sqrt(2.0) / d.mean(-1).clamp_min(1e-12)
    mean = mean[..., 0, :]
    T = torch.zeros(*x.shape[:-2], 3, 3, dtype=x.dtype, device=x.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 0, 2] = -scale * mean[..., 0]
    T[..., 1, 2] = -scale * mean[..., 1]
    T[..., 2, 2] = 1.0
    return (x - mean[..., None, :]) * scale[..., None, None], T


def _normalize_by_last(M: torch.Tensor) -> torch.Tensor:
    m22 = M[..., 2:3, 2:3]
    return M / torch.where(m22.abs() < 1e-12, torch.ones_like(m22), m22)


def fundamental_8point(
    x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor = None, fast: bool = False
) -> torch.Tensor:
    """Normalized 8-point fundamental matrices from (..., N, 2)
    correspondences (N = 8 when ``fast``).

    ``w``: optional (..., N) per-correspondence weights (weighted refits).
    ``fast``: fixed-last-component null vector and NO rank-2 enforcement,
    for hypothesis scoring (the refits rebuild F exactly)."""
    n1, T1 = _normalize_points(x1)
    n2, T2 = _normalize_points(x2)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    A = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1
    )
    if w is not None:
        A = A * w[..., None]
    if fast:
        F = nullvec_fix_last(A).unflatten(-1, (3, 3))
    else:
        F = smallest_right_vector(A).unflatten(-1, (3, 3))
        # Rank-2 projection U diag(s1, s2, 0) Vᵀ = F (I - v3 v3ᵀ), with v3
        # the right singular vector of F's smallest singular value.
        v3 = smallest_right_vector(F)
        F = F - (F @ v3[..., None]) @ v3[..., None, :]
    return _normalize_by_last(T2.transpose(-1, -2) @ F @ T1)


def _apply(M: torch.Tensor, x: torch.Tensor, transpose: bool = False):
    """The three rows of M @ [x, y, 1] (of Mᵀ @ [x, y, 1] with
    ``transpose``) for M (..., 3, 3) and x (..., N, 2): three (..., N)
    tensors, in elementwise products (no matmul, so no TF32 and no
    broadcast copy of x per hypothesis)."""
    if transpose:
        M = M.transpose(-1, -2)
    x, y = x[..., 0], x[..., 1]
    return tuple(M[..., k, 0:1] * x + M[..., k, 1:2] * y + M[..., k, 2:3] for k in range(3))


def sampson_error(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance (px^2): F (..., 3, 3), x (..., N, 2) -> (..., N)."""
    a0, a1, a2 = _apply(F, x1)  # F @ x1
    b0, b1, _ = _apply(F, x2, transpose=True)  # F^T @ x2
    num = (x2[..., 0] * a0 + x2[..., 1] * a1 + a2) ** 2
    den = a0**2 + a1**2 + b0**2 + b1**2
    return num / den.clamp_min(1e-12)


def homography_dlt(
    x1: torch.Tensor, x2: torch.Tensor, fast: bool = False, w: torch.Tensor = None
) -> torch.Tensor:
    """Normalized DLT homographies from (..., N, 2) correspondences (N = 4
    when ``fast``: fixed-last-component null vector).  ``w``: optional
    (..., N) per-correspondence weights (weighted refits)."""
    n1, T1 = _normalize_points(x1)
    n2, T2 = _normalize_points(x2)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    rows1 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    rows2 = torch.stack([z, z, z, u1, v1, o, -v2 * u1, -v2 * v1, -v2], dim=-1)
    A = torch.cat([rows1, rows2], dim=-2)
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    if fast:
        H = nullvec_fix_last(A).unflatten(-1, (3, 3))
    else:
        H = smallest_right_vector(A).unflatten(-1, (3, 3))
    # inv(T2) in closed form: T2 scales by s and shifts by -s * mean.
    s = T2[..., 0, 0]
    T2_inv = torch.zeros_like(T2)
    T2_inv[..., 0, 0] = 1.0 / s
    T2_inv[..., 1, 1] = 1.0 / s
    T2_inv[..., 0, 2] = -T2[..., 0, 2] / s
    T2_inv[..., 1, 2] = -T2[..., 1, 2] / s
    T2_inv[..., 2, 2] = 1.0
    return _normalize_by_last(T2_inv @ H @ T1)


def homography_error(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared transfer error |H x1 - x2|^2 (px^2): (..., N)."""
    p0, p1, p2 = _apply(H, x1)
    w = torch.where(p2.abs() < 1e-12, torch.full_like(p2, 1e-12), p2)
    return (p0 / w - x2[..., 0]) ** 2 + (p1 / w - x2[..., 1]) ** 2


def essential_from_fundamental(F: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    E = K2.transpose(-1, -2) @ F @ K1
    # Project onto the essential manifold (two equal singular values).
    u, s, vt = torch.linalg.svd(E)
    sm = (s[..., 0] + s[..., 1]) / 2.0
    diag = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    return (u * diag[..., None, :]) @ vt


def decompose_essential(E: torch.Tensor):
    """Returns the 4 (R, t) candidates."""
    u, _, vt = torch.linalg.svd(E)
    # Ensure proper rotations.
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.transpose(0, 1) @ vt
    t = u[..., :, 2]
    return (R1, t), (R1, -t), (R2, t), (R2, -t)


def triangulation_angles(
    points: torch.Tensor, center1: torch.Tensor, center2: torch.Tensor
) -> torch.Tensor:
    """Angle (rad) subtended at each point by the two camera centers."""
    d1 = points - center1
    d2 = points - center2
    cosang = (d1 * d2).sum(-1) / (d1.norm(dim=-1) * d2.norm(dim=-1)).clamp_min(1e-12)
    return torch.arccos(cosang.clamp(-1.0, 1.0))
