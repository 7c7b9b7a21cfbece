"""Batched robust Levenberg-Marquardt over padded patch-graph components.

Port of lfr_tpu/solver/lm.py.  The components of one size bucket are solved
together, the batch axis leading every tensor: residuals, robust weights,
dense normal equations and Cholesky solves.

Semantics (reference: multi-view-refinement/solve.cc, cost.cc):
  * residual r = x_dst - x_src - flow(x_src), the flow interpolated
    biquadratically with the clamp of ``ops.interpolate``;
  * similarity-scaled Cauchy(0.25) on intra-track edges, Tukey(0.0625) on
    inter-track edges, by IRLS;
  * anchors (track roots) frozen, all else box-bounded to +-1 unit;
  * Ceres-style stopping rules, per lane.

JAX runs one ``while_loop`` per lane under ``vmap``, which freezes a lane
once it is done.  Here a host loop runs the whole batch for at most
``max_iter`` steps and masks every state update with ``~done``; every lane
starts at step 0, so one counter serves them all.  Stopping once every lane
is done changes no result; the loop asks the device every
``CHECK_EVERY`` steps.

The normal equations are ``J^T W J`` and ``J^T W r`` with the Jacobian J
laid out densely over the lane's nodes (one-hot placement, exact) and one
batched f32 product: no scatter, so no atomics, and the same bits on every
run.  The products run with TF32 off whatever the caller's setting.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import (
    CAUCHY_SCALE,
    LM_FUNCTION_TOLERANCE,
    LM_GRADIENT_TOLERANCE,
    LM_MAX_ITERATIONS,
    LM_PARAMETER_TOLERANCE,
    SOLVE_BOUND,
    TUKEY_SCALE,
)
from ..device import resolve_device
from ..ops.interpolate import interpolate_flow, interpolate_flow_and_jacobian
from ..ops.matchers import strict_f32

#: Steps between two host reads of ``done.all()``.  Lanes converge in a
#: median of 4 iterations, so a read every 4 steps runs at most 3 masked
#: steps past the slowest lane and costs one host sync per 4 steps.
CHECK_EVERY = 4

#: Initial damping.
LAM0 = 1e-4


@dataclasses.dataclass
class ComponentBatch:
    """A bucket of components padded to (n_nodes, n_edges), as numpy arrays.

    ``edge_*`` use local node indices; invalid (padding) edges carry
    ``edge_valid=False`` and index node 0.
    """

    edge_src: np.ndarray    # (B, E) int32
    edge_dst: np.ndarray    # (B, E) int32
    edge_sim: np.ndarray    # (B, E) float32
    edge_flow: np.ndarray   # (B, E, 3, 3, 2) float32
    edge_intra: np.ndarray  # (B, E) bool: intra-track (Cauchy) vs inter (Tukey)
    edge_valid: np.ndarray  # (B, E) bool
    is_root: np.ndarray     # (B, N) bool
    node_valid: np.ndarray  # (B, N) bool

    @property
    def batch(self) -> int:
        return self.edge_src.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.is_root.shape[1]

    @property
    def n_edges(self) -> int:
        return self.edge_src.shape[1]


class EdgeArrays(NamedTuple):
    """A batch's edge tensors on one device, as the LM reads them."""

    src: torch.Tensor    # (B, E) int64
    dst: torch.Tensor    # (B, E) int64
    sim: torch.Tensor    # (B, E) f32
    flow: torch.Tensor   # (B, E, 3, 3, 2) f32
    intra: torch.Tensor  # (B, E) bool
    valid: torch.Tensor  # (B, E) bool


class LMResult(NamedTuple):
    x: torch.Tensor           # (B, N, 2) positions
    iterations: torch.Tensor  # (B,) int32 steps each lane ran
    cost: torch.Tensor        # (B,) final cost
    done: torch.Tensor        # (B,) bool converged (or stopped on a failure)
    steps: int                # steps the batch ran (the slowest lane's, or more)


def to_device(batch: ComponentBatch, device) -> Tuple[EdgeArrays, torch.Tensor]:
    """(EdgeArrays, free (B, N) bool) of a numpy batch on ``device``."""
    dev = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev, dtype=dtype)

    arrays = EdgeArrays(
        t(batch.edge_src, torch.int64), t(batch.edge_dst, torch.int64), t(batch.edge_sim),
        t(batch.edge_flow), t(batch.edge_intra), t(batch.edge_valid),
    )
    free = t(batch.node_valid) & ~t(batch.is_root)
    return arrays, free


# ---------------------------------------------------------------------------
# Robust losses (Ceres conventions: rho(s), s = squared residual norm).
# ---------------------------------------------------------------------------


def cauchy_rho(s: torch.Tensor, a: float = CAUCHY_SCALE) -> torch.Tensor:
    b = a * a
    return b * torch.log1p(s / b)


def cauchy_weight(s: torch.Tensor, a: float = CAUCHY_SCALE) -> torch.Tensor:
    b = a * a
    return 1.0 / (1.0 + s / b)


def tukey_rho(s: torch.Tensor, a: float = TUKEY_SCALE) -> torch.Tensor:
    b = a * a
    inner = 1.0 - s / b
    return torch.where(s <= b, (b / 3.0) * (1.0 - inner * inner * inner),
                       torch.full_like(s, b / 3.0))


def tukey_weight(s: torch.Tensor, a: float = TUKEY_SCALE) -> torch.Tensor:
    b = a * a
    inner = (1.0 - s / b).clamp_min(0.0)
    return inner * inner


# ---------------------------------------------------------------------------
# Batched primitives: x is (B, N, 2), every edge tensor (B, E, ...).
# ---------------------------------------------------------------------------


def _gather_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _residuals(x: torch.Tensor, arrays: EdgeArrays) -> torch.Tensor:
    xs = _gather_nodes(x, arrays.src)
    flow = interpolate_flow(arrays.flow, xs[..., 0], xs[..., 1])
    return _gather_nodes(x, arrays.dst) - xs - flow


def _edge_residuals(x: torch.Tensor, arrays: EdgeArrays) -> Tuple[torch.Tensor, torch.Tensor]:
    """r (B, E, 2) = x_dst - x_src - flow(x_src), and dflow/dx_src (B, E, 2, 2)."""
    xs = _gather_nodes(x, arrays.src)
    flow, dflow = interpolate_flow_and_jacobian(arrays.flow, xs[..., 0], xs[..., 1])
    return _gather_nodes(x, arrays.dst) - xs - flow, dflow


def _cost(x: torch.Tensor, arrays: EdgeArrays) -> torch.Tensor:
    """(B,) 0.5 * sum over valid edges of sim * rho (ScaledLoss)."""
    r = _residuals(x, arrays)
    s = (r * r).sum(-1)
    rho = torch.where(arrays.intra, cauchy_rho(s), tukey_rho(s))
    return 0.5 * torch.where(arrays.valid, arrays.sim * rho, torch.zeros_like(rho)).sum(-1)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) one-hot of ``idx`` (a comparison: no range check, so no sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _normal_equations(
    x: torch.Tensor, arrays: EdgeArrays, free: torch.Tensor, onehots=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H (B, 2N, 2N), g (B, 2N)) of the IRLS-weighted Gauss-Newton system.

    ``onehots`` = (one-hot of src, one-hot of dst), each (B, E, N), may be
    passed in so that a loop builds them once.
    """
    b, n = free.shape
    e = arrays.src.shape[1]
    r, dflow = _edge_residuals(x, arrays)
    s = (r * r).sum(-1)
    w = torch.where(arrays.intra, cauchy_weight(s), tukey_weight(s)) * arrays.sim
    w = torch.where(arrays.valid, w, torch.zeros_like(w))

    eye = torch.eye(2, dtype=x.dtype, device=x.device)
    a = -(eye + dflow)  # (B, E, 2, 2): d r / d x_src; d r / d x_dst = I
    if onehots is None:
        onehots = (_one_hot(arrays.src, n, x.dtype), _one_hot(arrays.dst, n, x.dtype))
    sel_src, sel_dst = onehots
    # J[b, (e, c), (m, k)]: a one-hot times a value is exact, so J holds each
    # edge's Jacobian entries and zeros, whatever the summation order below.
    jac = (sel_src[:, :, None, :, None] * a[:, :, :, None, :]
           + sel_dst[:, :, None, :, None] * eye[:, None, :])
    jac = jac.reshape(b, 2 * e, 2 * n)
    jw = jac * w.repeat_interleave(2, dim=1)[:, :, None]
    with strict_f32():
        h = torch.bmm(jw.transpose(1, 2), jac)
        g = torch.bmm(jw.transpose(1, 2), r.reshape(b, 2 * e, 1))[..., 0]

    # Frozen roots and padding: zero rows and columns, unit diagonal, zero grad.
    fmask = free.to(x.dtype).repeat_interleave(2, dim=1)
    h = h * fmask[:, :, None] * fmask[:, None, :]
    h = h + torch.diag_embed(1.0 - fmask)
    return h, g * fmask


def lm_solve(
    arrays: EdgeArrays,
    free: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iter: int = LM_MAX_ITERATIONS,
) -> LMResult:
    """LM over every lane of a batch, as ``jax.vmap(_lm_single)`` computes it."""
    b, n = free.shape
    dtype, dev = torch.float32, free.device
    x = torch.zeros(b, n, 2, dtype=dtype, device=dev) if x0 is None else x0.clone()
    lam = torch.full((b,), LAM0, dtype=dtype, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    iterations = torch.zeros(b, dtype=torch.int32, device=dev)
    onehots = (_one_hot(arrays.src, n, dtype), _one_hot(arrays.dst, n, dtype))
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)
    cost = _cost(x, arrays)
    step = 0
    while step < max_iter:
        active = ~done
        h, g = _normal_equations(x, arrays, free, onehots)
        diag = h.diagonal(dim1=1, dim2=2).clamp(1e-6, 1e32)
        hd = h + lam[:, None, None] * torch.diag_embed(diag)
        chol, info = torch.linalg.cholesky_ex(hd)
        y = torch.linalg.solve_triangular(chol, -g[..., None], upper=False)
        delta = torch.linalg.solve_triangular(chol.mT, y, upper=True)
        # A failed factorization is JAX's NaN factor: the step is not finite,
        # the lane keeps x and ends.
        delta = torch.where((info != 0)[:, None, None], nan, delta).reshape(b, n, 2)
        delta = torch.where(free[..., None], delta, torch.zeros_like(delta))
        x_new = (x + delta).clamp(-SOLVE_BOUND, SOLVE_BOUND)
        new_cost = _cost(x_new, arrays)
        finite = torch.isfinite(new_cost)
        accept = finite & (new_cost < cost)
        take = accept & active

        x = torch.where(take[:, None, None], x_new, x)
        lam = torch.where(
            active,
            torch.where(accept, (lam / 3.0).clamp_min(1e-10), (lam * 4.0).clamp_max(1e10)),
            lam,
        )
        step_small = delta.abs().amax(dim=(1, 2)) <= LM_PARAMETER_TOLERANCE * (
            x.abs().amax(dim=(1, 2)) + LM_PARAMETER_TOLERANCE
        )
        cost_small = (cost - new_cost).abs() <= LM_FUNCTION_TOLERANCE * cost.clamp_min(1e-20)
        grad_small = g.abs().amax(dim=1) <= LM_GRADIENT_TOLERANCE
        stop = (accept & (cost_small | step_small)) | grad_small | ~finite
        cost = torch.where(take, new_cost, cost)
        iterations += active.to(torch.int32)
        done = done | (active & stop)
        step += 1
        if step % CHECK_EVERY == 0 and step < max_iter and bool(done.all()):
            break
    return LMResult(x, iterations, cost, done, step)


def solve_component_batch_staged(
    arrays: EdgeArrays,
    free: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iter: int = LM_MAX_ITERATIONS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions (B, N, 2), done (B,)) of a bucket, optionally warm-started.

    solve.py runs every bucket at a short budget first, then only
    the lanes that are not done, from the positions they reached, with the
    rest of the budget (LM restarted: ``lam`` and ``cost`` start afresh)."""
    res = lm_solve(arrays, free, x0, max_iter)
    return res.x, res.done


def solve_component_batch(
    arrays: EdgeArrays, free: torch.Tensor, max_iter: int = LM_MAX_ITERATIONS
) -> torch.Tensor:
    """Positions (B, N, 2) of a bucket solved from zero."""
    return lm_solve(arrays, free, None, max_iter).x


def solve_batch(
    batch: ComponentBatch, max_iter: int = LM_MAX_ITERATIONS, device="cuda"
) -> np.ndarray:
    """Numpy in, numpy (B, N, 2) out; the solve runs on ``device``."""
    arrays, free = to_device(batch, device)
    return solve_component_batch(arrays, free, max_iter).cpu().numpy()
