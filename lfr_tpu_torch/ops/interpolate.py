"""Biquadratic (3x3 Lagrange) flow-grid interpolation, with its derivative.

Port of lfr_tpu/ops/interpolate.py.  The multi-view solver evaluates each
edge's 3x3 displacement grid at the current source position by quadratic
Lagrange interpolation with nodes at {-0.5, 0, 0.5}, clamping queries to the
box (reference: multi-view-refinement/cost.cc:7-72).  The JAX package takes
the derivative by autodiff through ``jnp.clip``; here it is in closed form,
with the clamp's derivative as JAX's: 1 inside the box, 0 outside and 0.5
at exactly +-0.5 (``clip`` is ``min(max(x, lo), hi)``, and JAX splits the
derivative of ``max`` / ``min`` evenly at a tie).
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Query box: grid samples live at offsets {-0.5, 0, 0.5} displacement units.
BOX = 0.5


def lagrange_weights(t: torch.Tensor) -> torch.Tensor:
    """Quadratic Lagrange basis at nodes (-0.5, 0, 0.5) for query t.
    Returns (..., 3)."""
    return torch.stack(
        [2.0 * t * (t - 0.5), -4.0 * (t - 0.5) * (t + 0.5), 2.0 * t * (t + 0.5)], dim=-1
    )


def lagrange_derivatives(t: torch.Tensor) -> torch.Tensor:
    """d/dt of :func:`lagrange_weights`.  Returns (..., 3)."""
    return torch.stack([4.0 * t - 1.0, -8.0 * t, 4.0 * t + 1.0], dim=-1)


def _clip_derivative(t: torch.Tensor) -> torch.Tensor:
    inside = (t > -BOX) & (t < BOX)
    edge = (t == -BOX) | (t == BOX)
    return inside.to(t.dtype) + 0.5 * edge.to(t.dtype)


def _contract(wr: torch.Tensor, wc: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """sum_ij wr_i wc_j grid[..., i, j, :], elementwise (no matmul, so no
    TF32 and the same summation order on every run)."""
    w = wr[..., :, None] * wc[..., None, :]
    return (w[..., None] * grid).sum(dim=(-3, -2))


def interpolate_flow(grid: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Evaluate flow grids at (row, col) query points.

    Args:
      grid: (..., 3, 3, C) flow samples (C=2: di, dj).
      row, col: (...,) query coordinates in displacement units.

    Returns (..., C); queries are clamped to [-0.5, 0.5]^2.
    """
    r = row.clamp(-BOX, BOX)
    c = col.clamp(-BOX, BOX)
    return _contract(lagrange_weights(r), lagrange_weights(c), grid)


def interpolate_flow_and_jacobian(
    grid: torch.Tensor, row: torch.Tensor, col: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`interpolate_flow` and its derivative in (row, col).

    Returns flow (..., C) and jac (..., C, 2) with
    ``jac[..., c, k] = d flow_c / d (row, col)_k``: what ``jax.jacfwd``
    gives for the JAX function, including the clamp's derivative.
    """
    r = row.clamp(-BOX, BOX)
    c = col.clamp(-BOX, BOX)
    wr, wc = lagrange_weights(r), lagrange_weights(c)
    dwr = lagrange_derivatives(r) * _clip_derivative(row)[..., None]
    dwc = lagrange_derivatives(c) * _clip_derivative(col)[..., None]
    flow = _contract(wr, wc, grid)
    jac = torch.stack([_contract(dwr, wc, grid), _contract(wr, dwc, grid)], dim=-1)
    return flow, jac
