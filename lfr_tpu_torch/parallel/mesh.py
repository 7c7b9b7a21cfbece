"""The ("dp", "mp") mesh over the ranks of the process group, its
collectives, and the tensor-parallel placement of PANet's state (port of
lfr_tpu/parallel/mesh.py).

The axes are the JAX package's:

- ``dp``: data parallel over patch / match batches (the CNN path);
- ``mp``: tensor parallel over the refine head's channels;
- components of the graph partitioner, and BA's points, split over the
  flattened mesh (every rank).

Ranks are laid out rank-major: rank r sits at (r // mp, r % mp), as
``create_device_mesh`` orders devices.  A world of one (no process group,
or ``make_mesh(1)``) needs no process group and makes every collective a
no-op that returns its input.  Collectives sum in f32 where a tensor is
bf16 or f16 (the result in the input's type).  Gloo takes CUDA tensors in
all_reduce, broadcast and all_gather (checked on the card with torch 2.11)
and stages them through the host itself.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import rank_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a dp x mp mesh: its rank, the device it drives,
    and the process groups of its dp and mp axes (None where the axis spans
    every rank or one)."""

    dp: int
    mp: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    dp_group: Optional[object] = None
    mp_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp

    def axis_size(self, axis: Optional[str]) -> int:
        return {"dp": self.dp, "mp": self.mp, None: self.size}[axis]

    def axis_index(self, axis: Optional[str]) -> int:
        return {"dp": self.dp_index, "mp": self.mp_index, None: self.rank}[axis]

    def _group(self, axis: Optional[str]):
        return {"dp": self.dp_group, "mp": self.mp_group, None: None}[axis]

    @staticmethod
    def _staged(x: torch.Tensor) -> torch.Tensor:
        """x as the collective takes it: contiguous, f32 for a 16-bit float."""
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.contiguous()

    def all_reduce(self, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """The sum of x over the ranks of ``axis`` (None: every rank), in
        x's type and on x's device; x itself when the axis has one rank."""
        if self.axis_size(axis) == 1:
            return x
        y = self._staged(x)
        if y is x:
            y = x.clone()
        dist.all_reduce(y, group=self._group(axis))
        return y.to(x.dtype)

    def all_gather(self, x: torch.Tensor, axis: Optional[str] = None, dim: int = 0) -> torch.Tensor:
        """Every rank's x of ``axis`` concatenated along ``dim`` in rank
        order (each rank's x has the same shape); x itself for one rank."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        y = self._staged(x)
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=self._group(axis))
        return torch.cat(parts, dim).to(x.dtype)


def _world() -> Tuple[int, int, Optional[str]]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    mp: Optional[int] = None,
    device="cuda",
) -> Mesh:
    """A ("dp", "mp") mesh over every rank of the process group (none: a
    world of one), or over this rank alone for ``n_devices=1``.

    By default all tensor parallelism is off (mp=1).  Every rank must call
    this with the same arguments (the axes' process groups are made
    collectively).  ``device``: "cuda" (this rank's card) or "cpu"."""
    world, rank, backend = _world()
    dev = rank_device(device, rank)
    n = world if n_devices is None else int(n_devices)
    if n == 1:
        world, rank, backend = 1, 0, None
    elif n != world:
        raise ValueError(f"a mesh spans every rank ({world}) or one, not {n}")
    if dp is None and mp is None:
        dp, mp = n, 1
    elif dp is None:
        dp = n // mp
    elif mp is None:
        mp = n // dp
    assert dp * mp == n, f"dp*mp must equal device count ({dp}*{mp} != {n})"
    dp_group = mp_group = None
    if 1 < dp < n or 1 < mp < n:
        # new_group is collective: every rank makes every group, in order.
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)])
            if d == rank // mp:
                mp_group = g
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if m == rank % mp:
                dp_group = g
    return Mesh(dp, mp, rank, dev, backend, dp_group, mp_group)


def batch_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a batch axis of ``n`` split over dp."""
    if n % mesh.dp:
        raise ValueError(f"batch {n} is no multiple of dp={mesh.dp}")
    per = n // mesh.dp
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def param_shardings(mesh: Mesh, state_dict: Dict[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """The dimension of each PANet state-dict entry that splits over ``mp``,
    or None where it is replicated: JAX's rule in torch layouts.

    The refine head's conv weights split their output channels (JAX HWIO
    dim 3, torch OIHW dim 0); their biases, the BatchNorm weight, bias and
    running statistics follow them (dim 0); the ``predict`` Dense kernel
    splits its 64 inputs (JAX (64, 2) dim 0, torch Linear (2, 64) dim 1).
    Everything else is replicated.  With mp=1 a split is the whole tensor."""
    out = {}
    for name, value in state_dict.items():
        dim = None
        if "refine" in name and value.ndim in (1, 4):
            dim = 0
        elif "predict" in name and value.ndim == 2:
            dim = 1
        out[name] = dim
    return out


def shard_state_dict(mesh: Mesh, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full state dict (e.g. ``panet.from_jax_variables``'s) -> this
    rank's shards (copies)."""
    dims = param_shardings(mesh, state_dict)
    for k, d in dims.items():
        if d is not None and state_dict[k].shape[d] % mesh.mp:
            raise ValueError(f"{k} {tuple(state_dict[k].shape)} does not split over mp={mesh.mp}")
    return {k: v.chunk(mesh.mp, dims[k])[mesh.mp_index].clone() if dims[k] is not None
            else v.clone() for k, v in state_dict.items()}


def gather_state_dict(mesh: Mesh, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's shards -> the full state dict (collective over mp: every
    rank must call it)."""
    dims = param_shardings(mesh, state_dict) if mesh.mp > 1 else {}
    out = {}
    for k, v in state_dict.items():
        v = v.detach()
        out[k] = mesh.all_gather(v, "mp", dims[k]) if dims.get(k) is not None else v.clone()
    return out


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad axis to a multiple (for even dp sharding); returns (padded, orig)."""
    n = array.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return array, n
    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(array, pad_width), n
