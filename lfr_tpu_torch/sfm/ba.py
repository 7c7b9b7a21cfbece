"""Bundle adjustment: Schur-complement Levenberg-Marquardt in torch on the
device (port of lfr_tpu/sfm/ba.py).

Observations are flat arrays (cam_idx, pt_idx, uv) grouped by point.  Their
residuals and Jacobians evaluate in closed form, batched over observations;
the point block of the normal equations is block-diagonal 3x3 and inverts
batched; the reduced camera system S = B - E C^-1 E^T is assembled chunk by
chunk over the point axis and solved by a dense Cholesky; the points
back-substitute in parallel.

Camera parameters per view: an SO(3) increment (exp retraction), the
translation, and a log-focal scale (frozen unless ``refine_focal``).  The
gauge is fixed by per-parameter freezing and the LM damping.

Determinism.  Every sum of the normal equations is a one-hot product or a
reduction over a fixed axis (no scatter-add with float atomics), so the card
gives the same bits on every run.  The products run with TF32 off, in float32
as the JAX package runs them (it never enables x64).

Differences from the JAX package by design: the Jacobians are written in
closed form (JAX takes ``jacfwd`` per observation); :func:`ba_iterate` is a
host loop whose updates are masked by ``~done`` (JAX: ``while_loop``); and
:func:`run_ba` does not pad the shapes to powers of two (JAX pads so that
its compiled programs are reused; the padding adds exact zeros).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.matchers import strict_f32

HUBER_DELTA_PX = 4.0

#: Camera parameters per view: rotation (3) + translation (3) + log-focal (1).
CAM_DOF = 7

#: Largest point chunk of the Schur assembly (see :func:`schur_step`).
POINT_CHUNK = 2048

#: Elements of the per-chunk one-hot (points x track length x cameras): the
#: chunk shrinks below POINT_CHUNK where tracks are long and cameras many.
CHUNK_ELEMENTS = 1 << 24

#: LM steps between two host reads of ``done`` in :func:`ba_iterate`.
CHECK_EVERY = 4


@dataclasses.dataclass
class BAProblem:
    """Flat bundle-adjustment problem in *normalized* camera coordinates.

    Observations must be grouped by point (``obs_pt`` non-decreasing).
    uv are undistorted normalized coords; residuals are scaled to pixels by
    ``focal`` per observation.
    """

    R: np.ndarray            # (C, 3, 3) world->cam
    t: np.ndarray            # (C, 3)
    points: np.ndarray       # (P, 3)
    obs_cam: np.ndarray      # (O,)
    obs_pt: np.ndarray       # (O,)
    obs_uv: np.ndarray       # (O, 2) normalized
    obs_focal: np.ndarray    # (O,) pixels-per-normalized-unit (for weighting)
    #: (C,) bool (fix whole pose) or (C, 6) bool per-parameter [w, dt] mask.
    fixed_cameras: np.ndarray
    #: Refine per-view log-focal scales.
    refine_focal: bool = False
    #: (C,) initial log-focal scales (default zeros).
    fscale: Optional[np.ndarray] = None
    #: Optional (C,) int group ids: views in one group share one focal scale.
    focal_group: Optional[np.ndarray] = None


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3), with the Taylor branch below
    |w|^2 = 1e-8 as the JAX package switches."""
    t2 = (w * w).sum(-1)
    small = t2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    safe_t = safe_t2.sqrt()
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(safe_t)) / safe_t2)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices [w]x."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def _project(c: torch.Tensor, scale: torch.Tensor):
    """(proj (..., 2), d proj / d c (..., 2, 3)) of camera points c (..., 3)
    under a focal scale: proj = c_xy / z * scale, z clamped at 1e-9 (where
    it is clamped, its derivative is 0, as autodiff of the clamp gives)."""
    tiny = c[..., 2].abs() < 1e-9
    z = torch.where(tiny, torch.full_like(c[..., 2], 1e-9), c[..., 2])
    proj = c[..., :2] / z[..., None] * scale[..., None]
    inv = scale / z
    dz = torch.where(tiny[..., None], torch.zeros_like(proj), -proj / z[..., None])
    zero = torch.zeros_like(inv)
    dproj = torch.stack(
        [torch.stack([inv, zero, dz[..., 0]], -1), torch.stack([zero, inv, dz[..., 1]], -1)], -2
    )
    return proj, dproj


def _residuals(R, t, fscale, points, obs_cam, obs_pt, obs_uv, obs_focal):
    """Per observation: the reprojection residual (O, 2) in px, the rotated
    point R X (O, 3), the projection (O, 2), its derivative by the camera
    point (O, 2, 3), and the observing camera's R (O, 3, 3)."""
    Ro = R[obs_cam]
    p = (Ro * points[obs_pt][:, None, :]).sum(-1)
    c = p + t[obs_cam]
    scale = torch.exp(fscale[obs_cam])
    proj, dproj = _project(c, scale)
    return (proj - obs_uv) * obs_focal[:, None], p, proj, dproj, Ro


def _huber_weights(r: torch.Tensor) -> torch.Tensor:
    norm = r.norm(dim=-1)
    return torch.where(
        norm <= HUBER_DELTA_PX, torch.ones_like(norm), HUBER_DELTA_PX / norm.clamp_min(1e-12)
    )


def obs_jacobians(R, t, fscale, points, obs_cam, obs_pt, obs_uv, obs_focal):
    """Residuals and Jacobians of every observation at a zero increment.

    Returns r (O, 2), Jc (O, 2, CAM_DOF) over [rotation increment,
    translation, log-focal], Jp (O, 2, 3) over the point, and the Huber
    weights (O,).  The rotation increment w enters as exp(w) R, so
    d c / d w = -[R X]x, d c / d t = I and d c / d X = R; the log-focal
    scales the projection, d proj / d s = proj."""
    r, p, proj, dproj, Ro = _residuals(R, t, fscale, points, obs_cam, obs_pt, obs_uv, obs_focal)
    f = obs_focal[:, None, None]
    dcam = torch.cat([-skew(p), torch.eye(3, dtype=p.dtype, device=p.device).expand_as(Ro)], -1)
    with strict_f32():
        Jc = torch.cat([dproj @ dcam, proj[..., None]], -1) * f
        Jp = (dproj @ Ro) * f
    return r, Jc, Jp, _huber_weights(r)


def _cost(R, t, fscale, points, obs_cam, obs_pt, obs_uv, obs_focal) -> torch.Tensor:
    """Huber cost (a 0-d tensor)."""
    r = _residuals(R, t, fscale, points, obs_cam, obs_pt, obs_uv, obs_focal)[0]
    s = (r * r).sum(-1)
    n = s.clamp_min(1e-20).sqrt()
    huber = torch.where(
        n <= HUBER_DELTA_PX, 0.5 * s, HUBER_DELTA_PX * (n - 0.5 * HUBER_DELTA_PX)
    )
    return huber.sum()


def _point_chunk(n_points: int, v: int, n_cameras: int) -> int:
    return max(1, min(POINT_CHUNK, n_points, CHUNK_ELEMENTS // max(v * n_cameras, 1)))


def _damp(M: torch.Tensor, lam) -> torch.Tensor:
    """Marquardt damping: M + lam diag(max(diag(M), 1e-6))."""
    diag = M.diagonal(dim1=-2, dim2=-1).clamp_min(1e-6)
    return M + lam * torch.diag_embed(diag)


def _group_blocks(Jc, Jp, idx, valid):
    """A point chunk's grouped blocks: Jp_g (pc, V, 2, 3), Jc_g (pc, V, 2,
    d) and E = Jc_gᵀ Jp_g (pc, V, d, 3), zero at padded slots."""
    o = idx.clamp_min(0)
    m = valid.to(Jp.dtype)
    Jp_g = Jp[o] * m[..., None, None]
    Jc_g = Jc[o] * m[..., None, None]
    E = Jc_g.transpose(-1, -2) @ Jp_g
    return Jp_g, Jc_g, E


def schur_step(
    Rc, tc, fsc, Xc, lam, obs_cam, obs_pt, obs_uv, obs_focal, free, pt_obs_idx,
    pt_obs_valid, n_cameras: int, tie=None, reduce=None,
):
    """One damped Gauss-Newton step through the Schur-reduced camera system.

    Returns (dc (C, CAM_DOF), dX (P, 3)); with ``lam = 0`` an undamped GN
    step.  ``tie``: optional (CAM_DOF*C, K) parameter-tying matrix: the
    solve runs in the reduced space z with dc = tie @ z (shared focal
    scales).  ``reduce``: optional sum of the camera system's parts over
    the ranks that hold the other points (``lfr_tpu_torch.parallel``); the
    camera solve then runs on the sums, the back-substitution on this
    rank's points.

    The point axis runs in chunks (at most POINT_CHUNK points, fewer where
    a chunk's one-hot would pass CHUNK_ELEMENTS).  Per chunk, each point's
    E C^-1 and E blocks are aggregated per observing camera by a batched
    one-hot product (G, H: (pc, C, d, 3)), and the pairing sum_p G_p H_pᵀ
    is one GEMM, (C·d, pc·3) @ (pc·3, C·d); the camera blocks B and the
    gradient come from the same one-hot.  No scatter-add: the same bits on
    every run.
    """
    with strict_f32():
        S, B, rhs_pt, blocks = _schur_assemble(
            Rc, tc, fsc, Xc, lam, obs_cam, obs_pt, obs_uv, obs_focal, free, pt_obs_idx,
            pt_obs_valid, n_cameras)
        if reduce is not None:
            S, B, rhs_pt = reduce(S, B, rhs_pt)
        dc = _camera_solve(S, B, rhs_pt, lam, free, n_cameras, tie)
        dX = _back_substitute(dc, blocks, obs_cam, pt_obs_idx, pt_obs_valid)
    return dc, dX if dX is not None else Xc.new_zeros(0, 3)


def _schur_assemble(
    Rc, tc, fsc, Xc, lam, obs_cam, obs_pt, obs_uv, obs_focal, free, pt_obs_idx,
    pt_obs_valid, n_cameras: int,
):
    """The camera system's parts over this set of points: S (C·d, C·d)
    without the camera blocks, B (C, d·d + d) the camera blocks and
    gradients, rhs_pt (C·d, 1); and what the back-substitution needs."""
    d = CAM_DOF
    dt, dev = Xc.dtype, Xc.device
    n_c = n_cameras
    r, Jc, Jp, w = obs_jacobians(Rc, tc, fsc, Xc, obs_cam, obs_pt, obs_uv, obs_focal)
    sw = w.sqrt()
    Jc = Jc * free[obs_cam][:, None, :] * sw[:, None, None]
    Jp = Jp * sw[:, None, None]
    rw = r * sw[:, None]

    n_p, v = pt_obs_idx.shape
    pc = _point_chunk(n_p, v, n_c)
    cams = torch.arange(n_c, device=dev)
    S = torch.zeros(n_c * d, n_c * d, dtype=dt, device=dev)
    B = torch.zeros(n_c, d * d + d, dtype=dt, device=dev)   # [B, g_c] per camera
    rhs_pt = torch.zeros(n_c * d, 1, dtype=dt, device=dev)
    Cp_inv_all, g_p_all = [], []
    eye3 = torch.eye(3, dtype=dt, device=dev)
    for s in range(0, n_p, pc):
        idx, valid = pt_obs_idx[s : s + pc], pt_obs_valid[s : s + pc]
        k = idx.shape[0]
        Jp_g, Jc_g, E = _group_blocks(Jc, Jp, idx, valid)
        onehot = ((obs_cam[idx.clamp_min(0)][..., None] == cams) & valid[..., None]).to(dt)
        r_g = rw[idx.clamp_min(0)] * valid[..., None].to(dt)
        # Camera blocks and gradient of the chunk's observations.
        JcTJc = (Jc_g.transpose(-1, -2) @ Jc_g).reshape(k * v, d * d)
        JcTr = (Jc_g.transpose(-1, -2) @ r_g[..., None])[..., 0].reshape(k * v, d)
        B = B + onehot.reshape(k * v, n_c).T @ torch.cat([JcTJc, JcTr], -1)
        # Point blocks (damped) and their inverses.
        Cp = (Jp_g.transpose(-1, -2) @ Jp_g).sum(1)
        g_p = (Jp_g.transpose(-1, -2) @ r_g[..., None])[..., 0].sum(1)
        Cp = _damp(Cp, lam)
        Cp_inv = torch.linalg.inv_ex(Cp + 1e-9 * eye3)[0]
        ECi = E @ Cp_inv[:, None]
        # Per-camera aggregation, then the pairing GEMM.
        oh_t = onehot.transpose(1, 2)                                # (k, C, V)
        G = torch.bmm(oh_t, ECi.reshape(k, v, d * 3)).reshape(k, n_c, d, 3)
        H = torch.bmm(oh_t, E.reshape(k, v, d * 3)).reshape(k, n_c, d, 3)
        G_flat = G.permute(1, 2, 0, 3).reshape(n_c * d, k * 3)
        H_flat = H.permute(1, 2, 0, 3).reshape(n_c * d, k * 3)
        S = S - G_flat @ H_flat.T
        # rhs: sum_v ECi_v g_p over each camera's slots = G g_p.
        rhs_pt = rhs_pt + G_flat @ g_p.reshape(k * 3, 1)
        Cp_inv_all.append(Cp_inv)
        g_p_all.append(g_p)
    return S, B, rhs_pt, (Jc, Jp, pc, Cp_inv_all, g_p_all)


def _camera_solve(S, B, rhs_pt, lam, free, n_cameras: int, tie=None):
    """dc (C, CAM_DOF) from the assembled (and reduced) camera system."""
    d = CAM_DOF
    n_c = n_cameras
    dt, dev = S.dtype, S.device
    cams = torch.arange(n_c, device=dev)
    Bc = _damp(B[:, : d * d].reshape(n_c, d, d), lam)
    rhs = B[:, d * d :] - rhs_pt.reshape(n_c, d)
    # Add the camera blocks to the diagonal blocks of S.
    S = S.reshape(n_c, d, n_c, d)
    S[cams, :, cams, :] = S[cams, :, cams, :] + Bc
    Sd = S.reshape(n_c * d, n_c * d)
    fmask = free.reshape(-1)
    Sd = Sd * fmask[:, None] * fmask[None, :] + torch.diag(1.0 - fmask)
    rhs_flat = (-rhs.reshape(-1)) * fmask
    if tie is None:
        return _cho_solve(Sd, rhs_flat).reshape(n_c, d)
    A = tie.T @ Sd @ tie
    A = A + 1e-12 * torch.eye(A.shape[0], dtype=dt, device=dev)
    z = _cho_solve(A, tie.T @ rhs_flat)
    return (tie @ z).reshape(n_c, d)


def _back_substitute(dc, blocks, obs_cam, pt_obs_idx, pt_obs_valid):
    """dX = C^-1 (-g_p - Eᵀ dc) over this set's points (None: no points)."""
    Jc, Jp, pc, Cp_inv_all, g_p_all = blocks
    dt = dc.dtype
    dX = []
    for j, s in enumerate(range(0, pt_obs_idx.shape[0], pc)):
        idx, valid = pt_obs_idx[s : s + pc], pt_obs_valid[s : s + pc]
        _, _, E = _group_blocks(Jc, Jp, idx, valid)
        dc_g = dc[obs_cam[idx.clamp_min(0)]] * valid[..., None].to(dt)
        ET_dc = (E.transpose(-1, -2) @ dc_g[..., None])[..., 0].sum(1)
        dX.append((Cp_inv_all[j] @ (-g_p_all[j] - ET_dc)[..., None])[..., 0])
    return torch.cat(dX) if dX else None


def _cho_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b by Cholesky with no host sync; a failed factorization
    gives NaN (JAX's NaN factor), so the step is rejected."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info != 0, torch.full_like(x, float("nan")), x)


@dataclasses.dataclass
class BAResult:
    R: torch.Tensor
    t: torch.Tensor
    fscale: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor
    iterations: int
    steps: int


def ba_iterate(
    R, t, fscale, points, obs_cam, obs_pt, obs_uv, obs_focal, free, pt_obs_idx,
    pt_obs_valid, n_cameras: int, iterations: int = 20, tie=None, tol=1e-6, reduce=None,
) -> BAResult:
    """The LM loop, as the JAX package's ``while_loop`` computes it.

    A host loop runs at most ``iterations`` steps and masks every update by
    ``~done``, so the steps it runs past ``done`` change nothing; it reads
    ``done`` every CHECK_EVERY steps.  ``tol``: relative cost-decrease
    stop.  ``BAResult.iterations`` counts the steps JAX would run,
    ``steps`` those run here.  ``reduce``: optional sum over the ranks that
    hold the other points (``lfr_tpu_torch.parallel.sharded.run_ba_sharded``)
    of the costs and the camera system, so that every rank takes the same
    branch on the global cost."""
    dt, dev = points.dtype, points.device
    if reduce is None:
        reduce_cost = None
    else:
        def reduce_cost(c):
            return reduce(c)[0]
    lam = torch.tensor(1e-3, dtype=dt, device=dev)
    cost = _cost(R, t, fscale, points, obs_cam, obs_pt, obs_uv, obs_focal)
    if reduce_cost is not None:
        cost = reduce_cost(cost)
    done = torch.tensor(False, device=dev)
    it = torch.tensor(0, device=dev)
    step = 0
    while step < iterations:
        dc, dX = schur_step(
            R, t, fscale, points, lam, obs_cam, obs_pt, obs_uv, obs_focal, free,
            pt_obs_idx, pt_obs_valid, n_cameras, tie=tie, reduce=reduce,
        )
        dc = dc * free
        with strict_f32():
            R_new = so3_exp(dc[:, :3]) @ R
        t_new = t + dc[:, 3:6]
        fs_new = fscale + dc[:, 6]
        X_new = points + dX
        new_cost = _cost(R_new, t_new, fs_new, X_new, obs_cam, obs_pt, obs_uv, obs_focal)
        if reduce_cost is not None:
            new_cost = reduce_cost(new_cost)
        finite = torch.isfinite(new_cost)
        accept = finite & (new_cost < cost)
        take = accept & ~done
        R = torch.where(take, R_new, R)
        t = torch.where(take, t_new, t)
        fscale = torch.where(take, fs_new, fscale)
        points = torch.where(take, X_new, points)
        lam_new = torch.where(accept, (lam / 3.0).clamp_min(1e-10), (lam * 5.0).clamp_max(1e8))
        rel = (cost - new_cost).abs() / cost.clamp_min(1e-20)
        stop = (accept & (rel < tol)) | (~finite & (lam_new >= 1e8))
        cost = torch.where(take, new_cost, cost)
        lam = torch.where(done, lam, lam_new)
        it = it + (~done).to(it.dtype)
        done = done | stop
        step += 1
        if step % CHECK_EVERY == 0 and step < iterations and bool(done):
            break
    return BAResult(R, t, fscale, points, cost, int(it), step)


def _group_by_point(obs_pt: np.ndarray, n_points: int):
    """(P, V) padded observation-index groups per point; V is the longest
    track (at least 2), so every observation lies in exactly one group."""
    n_obs = obs_pt.shape[0]
    order = np.argsort(obs_pt, kind="stable")
    counts = np.bincount(obs_pt, minlength=n_points)
    v = int(max(counts.max() if n_obs else 0, 2))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(n_obs) - starts[obs_pt[order]]
    idx = np.full((n_points, v), -1, np.int64)
    idx[obs_pt[order], rank] = order
    valid = idx >= 0
    return idx, valid


def _free_mask(problem: BAProblem) -> np.ndarray:
    fixed = problem.fixed_cameras
    c = problem.R.shape[0]
    if fixed.ndim == 1:
        pose_free = np.repeat((~fixed)[:, None], 6, axis=1)
    else:
        pose_free = ~fixed[:, :6]
    focal_free = np.full(
        (c, 1), problem.refine_focal, bool
    ) & pose_free.any(axis=1, keepdims=True)
    return np.concatenate([pose_free, focal_free], axis=1).astype(np.float32)


def _tie_matrix(focal_group: np.ndarray, free: np.ndarray) -> np.ndarray:
    """(CAM_DOF*C, 6C + G) map from (per-view poses, per-GROUP focals) to
    the flat per-view parameter vector."""
    c = focal_group.shape[0]
    d = CAM_DOF
    groups = np.unique(focal_group)
    n_red = 6 * c + groups.shape[0]
    T = np.zeros((d * c, n_red), np.float32)
    for v in range(c):
        T[d * v : d * v + 6, 6 * v : 6 * v + 6] = np.eye(6)
        gi = int(np.searchsorted(groups, focal_group[v]))
        # Frozen focals stay out of the shared parameter (their row of the
        # masked system is identity anyway).
        if free[v, 6] > 0:
            T[d * v + 6, 6 * c + gi] = 1.0
    return T


def problem_tensors(problem: BAProblem, device):
    """The problem's arrays on ``device``: float32 values (as JAX's
    ``jnp.asarray`` rounds them), int64 indices, and the free mask, the
    point groups and the tie matrix (None unless focals are shared)."""
    dev = torch.device(device)
    n_c = problem.R.shape[0]
    free = _free_mask(problem)
    fscale = problem.fscale if problem.fscale is not None else np.zeros(n_c)
    pt_idx, pt_valid = _group_by_point(problem.obs_pt, problem.points.shape[0])
    tie = (
        _tie_matrix(problem.focal_group, free)
        if problem.focal_group is not None and problem.refine_focal
        else None
    )

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    return dict(
        R=f32(problem.R), t=f32(problem.t), fscale=f32(fscale), points=f32(problem.points),
        obs_cam=i64(problem.obs_cam), obs_pt=i64(problem.obs_pt), obs_uv=f32(problem.obs_uv),
        obs_focal=f32(problem.obs_focal), free=f32(free), pt_obs_idx=i64(pt_idx),
        pt_obs_valid=torch.as_tensor(pt_valid, device=dev),
        tie=None if tie is None else f32(tie),
    )


def run_ba(
    problem: BAProblem, iterations: int = 30, tol: float = 1e-6, device="cuda",
    stats: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """Solve; returns (R, t, log_focal_scales, points, final_cost) as
    float32 numpy arrays and a float.  ``stats``, if given, gains
    ``iterations`` (LM steps of the JAX loop) and ``steps`` (run here)."""
    dev = resolve_device(device)
    n_c = problem.R.shape[0]
    a = problem_tensors(problem, dev)
    res = ba_iterate(
        a["R"], a["t"], a["fscale"], a["points"], a["obs_cam"], a["obs_pt"], a["obs_uv"],
        a["obs_focal"], a["free"], a["pt_obs_idx"], a["pt_obs_valid"], n_cameras=n_c,
        iterations=iterations, tie=a["tie"], tol=tol,
    )
    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + res.iterations
        stats["steps"] = stats.get("steps", 0) + res.steps
    return (
        res.R.cpu().numpy(),
        res.t.cpu().numpy(),
        res.fscale.cpu().numpy(),
        res.points.cpu().numpy(),
        float(res.cost),
    )
