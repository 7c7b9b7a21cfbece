"""Sharded training, solving and bundle adjustment over a mesh of ranks
(port of lfr_tpu/parallel/sharded.py).

The JAX package writes one GSPMD program and lets XLA place the
collectives.  Here each rank runs its part and the collectives are
explicit:

- **Train step** (:func:`shard_model`, :func:`make_sharded_train_step`): the
  batch splits over ``dp``; the refine head is tensor-parallel over ``mp``
  (Megatron style: column-parallel convs, a row-parallel ``predict``);
  BatchNorm takes its statistics over the global batch (the dp ranks'
  moments summed, as flax's BatchNorm inside one GSPMD program sees the
  whole batch); the loss is the global batch's mean; gradients of
  replicated parameters are summed over ``dp``; Adam steps each rank's
  shards.
- **Component solve** (:func:`sharded_solve_batch`): the component axis
  pads to a multiple of the mesh size and splits over every rank; each
  rank solves its rows, then the positions are all-gathered.
- **Bundle adjustment** (:func:`run_ba_sharded`): the points split into
  contiguous ranges, each rank taking every observation of its points; the
  camera system's parts and the costs are summed over the ranks, every
  rank solves the same camera system and back-substitutes its own points,
  and the accept test and the stop read the global cost, so every rank
  takes the same branch.

At a world of one every collective is a no-op and each function equals its
unsharded form bit for bit: ``models.train.train_step``,
``solver.lm.lm_solve`` / ``solve_batch`` and ``sfm.ba.run_ba``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import panet
from ..models import train as train_mod
from ..sfm import ba as ba_mod
from ..solver import lm
from .mesh import Mesh, batch_rows, gather_state_dict, pad_to_multiple, param_shardings, \
    shard_state_dict
from .multiprocess import local_rows

# ---------------------------------------------------------------------------
# Collectives under autograd.  Each is the identity at an axis of one rank.
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the axis (the
    replicated input of a column-parallel layer: each rank's slice of the
    output contributes its part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the axis forward; identity backward (a row-parallel layer's
    partial products, after which every rank computes the same loss)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _SumOver(torch.autograd.Function):
    """Sum over the axis forward and backward (each rank's loss depends on
    every rank's contribution: BatchNorm's moments over dp)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.axis), None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` forward; reduce-scatter backward (the sum
    of every rank's gradient of the gathered tensor, this rank's slice)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        n, i = ctx.mesh.axis_size(ctx.axis), ctx.mesh.axis_index(ctx.axis)
        return ctx.mesh.all_reduce(grad, ctx.axis).chunk(n, ctx.dim)[i], None, None, None


def _apply(fn, x, mesh: Mesh, axis: str, *args):
    return x if mesh.axis_size(axis) == 1 else fn.apply(x, mesh, axis, *args)


# ---------------------------------------------------------------------------
# The tensor-parallel refine head.
# ---------------------------------------------------------------------------


class ColumnParallelConv(panet.Conv):
    """A head conv holding this rank's output channels.  Its input is the
    full-channel tensor: the previous stage's shards gathered over mp, or,
    for conv0, the replicated correlation volume."""

    def __init__(self, cin: int, cout_local: int, kernel: int, mesh: Mesh, gather_input: bool):
        super().__init__(cin, cout_local, kernel)
        self.mesh = mesh
        self.gather_input = gather_input

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gather_input:
            x = _apply(_GatherFrom, x, self.mesh, "mp", 1)
        else:
            x = _apply(_CopyTo, x, self.mesh, "mp")
        return super().forward(x)


class DataParallelBatchNorm(panet.BatchNorm):
    """flax's BatchNorm over the global batch: each dp rank's moments
    (E[x], E[x^2]) summed over dp and divided by dp (the ranks hold equal
    rows), so the fast variance and the running update are the same on
    every rank."""

    def __init__(self, features: int, mesh: Mesh):
        super().__init__(features)
        self.mesh = mesh

    def moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, mean_sq = super().moments(x)
        if self.mesh.dp == 1:
            return mean, mean_sq
        both = _SumOver.apply(torch.stack([mean, mean_sq]), self.mesh, "dp") / self.mesh.dp
        return both[0], both[1]


class RowParallelLinear(nn.Linear):
    """``predict`` holding this rank's input rows: the partial products
    summed over mp, then the replicated bias."""

    def __init__(self, in_local: int, out: int, mesh: Mesh):
        super().__init__(in_local, out)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh.mp == 1:
            return F.linear(x, self.weight, self.bias)
        return _ReduceFrom.apply(F.linear(x, self.weight), self.mesh, "mp") + self.bias


def shard_model(model: panet.PANet, mesh: Mesh) -> panet.PANet:
    """Make an unfolded PANet holding full weights (every rank the same)
    tensor-parallel over ``mesh``'s mp axis, in place: the head's convs,
    BatchNorms and ``predict`` become this rank's shards (by
    :func:`lfr_tpu_torch.parallel.mesh.param_shardings`), on the model's
    device.  Build the optimizer afterwards."""
    if model.folded:
        raise ValueError("shard_model takes the unfolded (trainable) PANet")
    dev = next(model.parameters()).device
    full = model.state_dict()
    head, chans = model.refine, [panet.FMAP * panet.FMAP, 128, 128, 64, 64]
    for i in range(4):
        cout = chans[i + 1] // mesh.mp
        setattr(head, f"conv{i}", ColumnParallelConv(chans[i], cout, 5, mesh, i > 0))
        setattr(head, f"bn{i}", DataParallelBatchNorm(cout, mesh))
    model.predict = RowParallelLinear(chans[4] // mesh.mp, 2, mesh)
    model.load_state_dict(shard_state_dict(mesh, full))
    return model.to(dev)


def gather_variables(model: panet.PANet, mesh: Mesh) -> dict:
    """A sharded model's state -> the full variables in the JAX layout
    (``panet.to_jax_variables``).  Collective over mp: every rank calls it."""
    full = panet.PANet(model.compute_dtype, folded=False)
    full.load_state_dict(gather_state_dict(mesh, model.state_dict()))
    return panet.to_jax_variables(full)


def _all_reduce_grads(mesh: Mesh, params, axis: Optional[str], scale: int = 1) -> None:
    """Sum the gradients of ``params`` over ``axis`` in one collective, then
    divide by ``scale``."""
    if not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), axis)
    if scale != 1:
        flat = flat / scale
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def make_sharded_train_step(model: panet.PANet, optimizer: torch.optim.Optimizer, mesh: Mesh,
                            scheduler=None):
    """The sharded form of ``models.train.train_step``: returns
    ``step(ref, tgt, delta) -> loss``, the global batch in, the global
    batch's loss out (the same on every rank, not synchronised to the host).

    ``model`` is :func:`shard_model`'s and ``optimizer`` holds exactly its
    parameters.  Every rank passes the same global batch and takes its dp
    rows.  Gradients: sharded parameters summed over dp; replicated ones
    summed over every rank and divided by mp (the mp replicas hold the same
    gradient up to the card's summation order, so the replicas stay
    equal)."""
    if not isinstance(model.predict, RowParallelLinear) or model.predict.mesh is not mesh:
        raise ValueError("shard_model(model, mesh) first, then build the optimizer")
    named = dict(model.named_parameters())
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    if held != {id(p) for p in named.values()}:
        raise ValueError("the optimizer must hold the sharded model's parameters")
    dims = param_shardings(mesh, named)
    replicated = [p for k, p in named.items() if dims[k] is None]
    split = [p for k, p in named.items() if dims[k] is not None]

    def step(ref: torch.Tensor, tgt: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        rows = batch_rows(mesh, ref.shape[0])
        optimizer.zero_grad(set_to_none=True)
        # The global mean is the mean of the dp ranks' means (equal rows).
        loss = train_mod.loss_fn(model, ref[rows], tgt[rows], delta[rows]) / mesh.dp
        loss.backward()
        if mesh.mp == 1:
            _all_reduce_grads(mesh, replicated + split, "dp")
        else:
            _all_reduce_grads(mesh, replicated, None, mesh.mp)
            _all_reduce_grads(mesh, split, "dp")
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return mesh.all_reduce(loss.detach(), "dp")

    return step


# ---------------------------------------------------------------------------
# Component solve and bundle adjustment.
# ---------------------------------------------------------------------------

_BATCH_FIELDS = ("edge_src", "edge_dst", "edge_sim", "edge_flow", "edge_intra", "edge_valid",
                 "is_root", "node_valid")


def sharded_lm(batch: lm.ComponentBatch, mesh: Mesh, max_iter: int = 25):
    """(positions (B, N, 2), iterations (B,), this rank's LM steps) of a
    bucket solved over every rank of ``mesh``: padded to a multiple of the
    mesh size (zero lanes, all frozen), each rank uploading and solving its
    rows from zero, the results all-gathered and the padding dropped."""
    b = batch.batch
    padded = {f: pad_to_multiple(np.asarray(getattr(batch, f)), mesh.size)[0]
              for f in _BATCH_FIELDS}
    lo, hi = local_rows(padded["edge_src"].shape[0], mesh.rank, mesh.size)
    local = lm.ComponentBatch(**{f: a[lo:hi] for f, a in padded.items()})
    arrays, free = lm.to_device(local, mesh.device)
    res = lm.lm_solve(arrays, free, max_iter=max_iter)
    x = mesh.all_gather(res.x).cpu().numpy()[:b]
    iterations = mesh.all_gather(res.iterations).cpu().numpy()[:b]
    return x, iterations, res.steps


def sharded_solve_batch(batch: lm.ComponentBatch, mesh: Mesh, max_iter: int = 25) -> np.ndarray:
    """Solve a component bucket with the batch axis split over every rank;
    numpy (B, N, 2) positions, the same on every rank."""
    return sharded_lm(batch, mesh, max_iter)[0]


def _local_problem(problem, lo: int, hi: int) -> ba_mod.BAProblem:
    """The points [lo, hi) of a problem and every observation of them."""
    keep = (problem.obs_pt >= lo) & (problem.obs_pt < hi)
    return ba_mod.BAProblem(
        problem.R, problem.t, problem.points[lo:hi], problem.obs_cam[keep],
        problem.obs_pt[keep] - lo, problem.obs_uv[keep], problem.obs_focal[keep],
        problem.fixed_cameras, problem.refine_focal, problem.fscale, problem.focal_group,
    )


def run_ba_sharded(problem, mesh: Mesh, iterations: int = 30, tol: float = 1e-6):
    """Bundle adjustment with the points split over every rank of ``mesh``;
    returns (R, t, log_focal_scales, points, final_cost) like
    ``sfm.ba.run_ba``, the same on every rank.

    Rank r takes the r-th contiguous range of ceil(P / ranks) points and
    every observation of them; cameras are replicated.  Per LM step the
    ranks sum the costs and the Schur system's parts (S, the camera blocks
    and gradients, the points' right-hand side) in one collective each."""
    n_pts = problem.points.shape[0]
    per = -(-n_pts // mesh.size)
    lo = min(mesh.rank * per, n_pts)
    hi = min(lo + per, n_pts)
    local = _local_problem(problem, lo, hi)
    a = ba_mod.problem_tensors(local, mesh.device)

    def reduce(*parts):
        flat = mesh.all_reduce(torch.cat([p.reshape(-1) for p in parts]))
        return [f.view_as(p) for p, f in zip(parts, flat.split([p.numel() for p in parts]))]

    res = ba_mod.ba_iterate(
        a["R"], a["t"], a["fscale"], a["points"], a["obs_cam"], a["obs_pt"], a["obs_uv"],
        a["obs_focal"], a["free"], a["pt_obs_idx"], a["pt_obs_valid"],
        n_cameras=problem.R.shape[0], iterations=iterations, tie=a["tie"], tol=tol,
        reduce=reduce if mesh.size > 1 else None,
    )
    X = res.points
    if mesh.size > 1:
        X = torch.cat([X, X.new_zeros(per - (hi - lo), 3)])
        X = mesh.all_gather(X)[:n_pts]
    return (
        res.R.cpu().numpy(),
        res.t.cpu().numpy(),
        res.fscale.cpu().numpy(),
        X.cpu().numpy(),
        float(res.cost),
    )
