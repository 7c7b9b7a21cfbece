"""lfr_tpu_torch.ops.interpolate against lfr_tpu.ops.interpolate.

The flow value and its closed-form derivative in (row, col) against JAX's
value and ``jax.jacfwd`` at atol 1e-6, on queries inside the box, outside
it, and at exactly +-0.5, where the clamp's derivative is 0.5 in JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfr_tpu.ops import interpolate as jax_interpolate
from lfr_tpu_torch.ops import interpolate

ATOL = 1e-6


def _queries(rng, n):
    q = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
    edges = np.asarray([[0.5, 0.1], [-0.5, -0.2], [0.3, 0.5], [0.0, -0.5], [0.5, 0.5],
                        [-0.5, 0.5], [0.6, 0.5], [-0.7, -0.5], [0.0, 0.0]], np.float32)
    return np.concatenate([q, edges])


def _jax_value_and_jacobian(grid, q):
    def flow_at(p, g):
        return jax_interpolate.interpolate_flow(g, p[0], p[1])

    return jax.vmap(lambda p, g: (flow_at(p, g), jax.jacfwd(flow_at)(p, g)))(
        jnp.asarray(q), jnp.asarray(grid))


def test_lagrange_weights_match_jax():
    t = np.linspace(-0.5, 0.5, 41, dtype=np.float32)
    got = interpolate.lagrange_weights(torch.from_numpy(t)).numpy()
    want = np.asarray(jax_interpolate.lagrange_weights(jnp.asarray(t)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # The weights interpolate: 1 at their own node, 0 at the others.
    nodes = interpolate.lagrange_weights(torch.tensor([-0.5, 0.0, 0.5])).numpy()
    np.testing.assert_allclose(nodes, np.eye(3), atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_and_jacobian_match_jax(seed):
    rng = np.random.default_rng(seed)
    q = _queries(rng, 64)
    grid = rng.standard_normal((q.shape[0], 3, 3, 2)).astype(np.float32)
    want_flow, want_jac = _jax_value_and_jacobian(grid, q)
    g, row, col = torch.from_numpy(grid), torch.from_numpy(q[:, 0]), torch.from_numpy(q[:, 1])
    flow, jac = interpolate.interpolate_flow_and_jacobian(g, row, col)
    np.testing.assert_allclose(flow.numpy(), np.asarray(want_flow), atol=ATOL, rtol=0)
    np.testing.assert_allclose(jac.numpy(), np.asarray(want_jac), atol=ATOL, rtol=0)
    np.testing.assert_allclose(interpolate.interpolate_flow(g, row, col).numpy(),
                               np.asarray(want_flow), atol=ATOL, rtol=0)


def test_clamp_derivative_is_jax_at_the_box_edges():
    """d flow / d row is 0 outside the box and half the inside value at +-0.5."""
    grid = np.zeros((4, 3, 3, 2), np.float32)
    grid[:, :, :, 0] = np.asarray([-1.0, 0.0, 1.0], np.float32)[:, None]  # flow_0 = row inside
    q = np.asarray([[0.5, 0.0], [-0.5, 0.0], [0.6, 0.0], [0.2, 0.0]], np.float32)
    _, want = _jax_value_and_jacobian(grid, q)
    _, jac = interpolate.interpolate_flow_and_jacobian(
        torch.from_numpy(grid), torch.from_numpy(q[:, 0]), torch.from_numpy(q[:, 1]))
    np.testing.assert_allclose(jac[:, 0, 0].numpy(), [1.0, 1.0, 0.0, 2.0], atol=ATOL)
    np.testing.assert_allclose(jac.numpy(), np.asarray(want), atol=ATOL, rtol=0)
