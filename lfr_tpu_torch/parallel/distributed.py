"""Process-group initialisation (port of lfr_tpu/parallel/distributed.py).

A single process needs nothing.  For N >= 2 processes every process calls
:func:`initialize` (from its arguments or the ``LFR_COORDINATOR`` /
``LFR_NUM_PROCESSES`` / ``LFR_PROCESS_ID`` environment) before any
collective; :func:`lfr_tpu_torch.parallel.mesh.make_mesh` then spans every
rank.  One process drives one device: rank r uses ``cuda:(r % cards)``.

The backend is chosen explicitly, never switched quietly:

- ``nccl`` when the device is CUDA and each rank owns its card
  (``num_processes <= torch.cuda.device_count()``, ranks on one host);
- ``gloo`` on the CPU, and for ranks that share a card: NCCL refuses two
  ranks on one device ("Duplicate GPU detected" at the first collective,
  torch 2.11 with NCCL 2.28 on the card).  Gloo stages CUDA tensors
  through the host.

Asking for ``nccl`` where it cannot run raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

BACKENDS = ("nccl", "gloo")

#: Seconds a collective may wait for the other ranks before it fails.
TIMEOUT_S = 600.0


def choose_backend(num_processes: int, device="cuda", backend: Optional[str] = None) -> str:
    """The backend for ``num_processes`` ranks on ``device``: ``backend`` if
    it can run (else ValueError), by default nccl where each rank owns its
    card (ranks on one host) and gloo otherwise."""
    own_cards = (torch.device(device).type == "cuda" and torch.cuda.is_available()
                 and num_processes <= torch.cuda.device_count())
    if backend is None:
        return "nccl" if own_cards else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and not own_cards:
        raise ValueError(
            f"nccl needs a CUDA card per rank: {num_processes} ranks on device {device!r} with "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} card(s); "
            "use backend='gloo' for ranks that share a card or run on the CPU")
    return backend


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """The device this rank drives: ``cuda:(rank % cards)`` for a CUDA
    device without an index, else ``device`` (raises without a card)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> bool:
    """Initialise the default process group from the arguments or the
    LFR_COORDINATOR (``host:port``), LFR_NUM_PROCESSES and LFR_PROCESS_ID
    environment variables.  Returns True if a process group was
    initialised, False without a coordinator."""
    coordinator_address = coordinator_address or os.environ.get("LFR_COORDINATOR")
    if coordinator_address is None:
        return False
    num_processes = num_processes or int(os.environ.get("LFR_NUM_PROCESSES", "0"))
    process_id = (
        process_id if process_id is not None else int(os.environ.get("LFR_PROCESS_ID", "0"))
    )
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}: need 0 <= id < n, n >= 1")
    backend = choose_backend(num_processes, device, backend)
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return True


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
