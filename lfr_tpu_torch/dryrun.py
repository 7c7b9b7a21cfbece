"""Dry runs: the one-device forward check and the multi-rank and
multi-process checks (port of the repo root's ``__graft_entry__.py``, which
stays the JAX package's).

    DRYRUN_DEVICES=2 DRYRUN_PROCESSES=2 python -m lfr_tpu_torch.dryrun

- :func:`entry`: ``(fn, args)``, PANet's symmetric two-view forward at full
  width in bf16 on zeros; on the card it launches the ``lfr_corr_sym``
  kernel.
- :func:`dryrun_multichip`: ``n`` spawned ranks of one process group, a
  ("dp", "mp") mesh with mp=2 when ``n`` is even: one sharded train step
  (finite loss), the sharded component solve at 192 nodes / 768 edges a
  component (parity with a world of one below 1e-3) and the sharded bundle
  adjustment on a noisy 12 x 400 problem (parity below 1e-3, cost > 0).
- :func:`dryrun_multiprocess`: ``launch(1)`` against ``launch(n)`` on the
  same problems (parity below 1e-3) and the process-boundary efficiency.

``DRYRUN_DEVICES`` (ranks of the multi-rank run), ``DRYRUN_PROCESSES``
(processes of the multi-process run), ``DRYRUN_PROCESSES_OUT`` (a JSON
file for that run's report) and ``DRYRUN_DEVICE`` ("cuda", the default, or
"cpu") drive ``python -m lfr_tpu_torch.dryrun``.  With one card the ranks
share it over gloo (``parallel.distributed``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from .device import resolve_device

#: Patch pairs of :func:`entry`'s forward.
ENTRY_BATCH = 64

#: Learning rate of the dry run's train step (constant: no warm-up at 0).
TRAIN_LR = 1e-3

#: Parity bound of the sharded solve and BA against a world of one.
PARITY_ATOL = 1e-3

#: :func:`dryrun_multiprocess`'s problems, the JAX package's: BA at 40 x
#: 4000 (160,000 observations, 15 steps) takes about a second on one CPU
#: process, so the figure measures the Schur path, not dispatch noise.
MULTIPROCESS_SIZES = dict(global_batch=512, iterations=25, ba_cams=40, ba_pts=4000,
                          ba_iters=15)


def _check(ok, message: str) -> None:
    """A dry run's gate: raise (also under ``python -O``) unless ``ok``."""
    if not ok:
        raise RuntimeError(message)


def entry(device="cuda"):
    """(fn, example_args): the folded full-width PANet in bf16, weights from
    ``panet.init_variables(0)``, and ``fn(reference, target)`` its
    ``forward_sym`` on two (64, 33, 33, 3) zero patch stacks -> ((64, 2),
    (64, 2))."""
    from .models import panet

    dev = resolve_device(device)
    variables = panet.fold_normalize_variables(panet.fold_bn_variables(panet.init_variables(0)))
    model = panet.PANet(torch.bfloat16)
    model.load_state_dict(panet.from_jax_variables(variables))
    model = model.to(dev).eval().requires_grad_(False)

    def forward(reference, target):
        with torch.no_grad():
            return model.forward_sym(reference, target)

    ref = torch.zeros((ENTRY_BATCH, 33, 33, 3), dtype=torch.float32, device=dev)
    tgt = torch.zeros((ENTRY_BATCH, 33, 33, 3), dtype=torch.float32, device=dev)
    return forward, (ref, tgt)


def train_batch(batch: int, seed: int = 0):
    """The dry run's (ref, tgt, delta) numpy batch: uniform [0, 255) patches
    and displacements in [0, 0.1) units, as the JAX package's dry run."""
    rng = np.random.default_rng(seed)
    ref = rng.random((batch, 33, 33, 3), dtype=np.float32) * 255
    tgt = rng.random((batch, 33, 33, 3), dtype=np.float32) * 255
    delta = rng.random((batch, 2), dtype=np.float32) * 0.1
    return ref, tgt, delta


def sharded_train_once(mesh, variables, batch, compute_dtype=torch.float32):
    """One sharded Adam step (constant TRAIN_LR) from ``variables`` on the
    global ``batch``: (loss, the variables after it in the JAX layout, the
    step's full gradients as numpy by torch parameter name).  Adam's first
    step is about lr times the sign of each gradient, whatever its scale, so
    the gradients are what shows a scaled collective."""
    from .models import train
    from .parallel import sharded
    from .parallel.mesh import gather_state_dict

    model = train.load_model(variables, compute_dtype, mesh.device).train()
    model = sharded.shard_model(model, mesh)
    optimizer, _ = train.make_optimizer(model, TRAIN_LR)
    step = sharded.make_sharded_train_step(model, optimizer, mesh)
    ref, tgt, delta = (torch.from_numpy(x).to(mesh.device) for x in batch)
    loss = float(step(ref, tgt, delta))
    grads = gather_state_dict(mesh, {k: p.grad for k, p in model.named_parameters()})
    return loss, sharded.gather_variables(model, mesh), \
        {k: g.float().cpu().numpy() for k, g in grads.items()}


def _multichip_rank(dp: int, mp: int, batch: int, device, matches_file=None,
                    solution_file=None) -> dict:
    """One rank of :func:`dryrun_multichip` (run under ``run_ranks``)."""
    import time

    from .models import panet
    from .parallel import multiprocess, sharded
    from .parallel.mesh import make_mesh
    from .solver import solve

    mesh = make_mesh(dp=dp, mp=mp, device=device)
    mesh1 = make_mesh(1, device=device)
    n = mesh.size

    # --- Sharded PANet train step (dp batch, mp refine channels). ---------
    variables = panet.init_variables(0)
    data = train_batch(batch)
    loss, after, grads = sharded_train_once(mesh, variables, data)
    _check(np.isfinite(loss), "sharded train step produced a non-finite loss")
    loss_bf16, _, _ = sharded_train_once(mesh, variables, data, torch.bfloat16)
    _check(np.isfinite(loss_bf16), "sharded bf16 train step produced a non-finite loss")

    # --- Sharded LM solve at a realistic bucket size (the partitioner caps
    # components at #images, so buckets carry hundreds of nodes and about a
    # thousand edges a component), against the same solve on one rank. ----
    b = n * 2
    cb = multiprocess.demo_component_batch(b, n=192, e=768)
    out = sharded.sharded_solve_batch(cb, mesh, max_iter=10)
    _check(out.shape == (b, 192, 2) and np.isfinite(out).all(), f"sharded solve gave {out.shape}")
    out1 = sharded.sharded_solve_batch(cb, mesh1, max_iter=10)
    solve_parity = float(np.max(np.abs(out - out1)))
    _check(solve_parity < PARITY_ATOL, f"sharded solve parity {solve_parity:.2e}")

    # --- Sharded BA on a noisy problem (cost > 0), against one rank. ------
    prob = multiprocess.demo_ba_problem(n_cam=12, n_pts=400)
    _, tb, _, Xb, cost = sharded.run_ba_sharded(prob, mesh, iterations=5)
    _check(np.isfinite(cost), "sharded BA produced a non-finite cost")
    _check(cost > 0, "the BA problem must be noisy (cost 0 proves nothing)")
    _, t1, _, X1, cost1 = sharded.run_ba_sharded(prob, mesh1, iterations=5)
    ba_parity = max(float(np.max(np.abs(tb - t1))), float(np.max(np.abs(Xb - X1))))
    _check(ba_parity < PARITY_ATOL, f"sharded BA parity {ba_parity:.2e}")

    solve_file = None
    if matches_file is not None:
        spans = {}
        t0 = time.perf_counter()
        solve.solve_file(matches_file, solution_file, device=device, verbose=False,
                         sub_spans=spans, use_mesh=True)
        solve_file = {"seconds": time.perf_counter() - t0, "sub_spans": spans}

    return {
        "solve_file": solve_file,
        "rank": mesh.rank, "dp": dp, "mp": mp, "backend": mesh.backend,
        "device": str(mesh.device), "train_batch": batch, "train_loss": loss,
        "train_loss_bf16": loss_bf16, "train_variables": after if mesh.rank == 0 else None,
        "train_grads": grads if mesh.rank == 0 else None,
        "solve_batch": list(out.shape), "solve_edges": int(cb.edge_src.shape[1]),
        "solve_parity_max_abs": solve_parity, "ba_cost": cost, "ba_cost_one_rank": cost1,
        "ba_obs": int(prob.obs_cam.shape[0]),
        "ba_rms_px": float(np.sqrt(2 * cost / prob.obs_cam.shape[0])),
        "ba_parity_max_abs": ba_parity,
    }


def dryrun_multichip(n_devices: int, batch: Optional[int] = None, device="cuda",
                     matches_file: Optional[str] = None,
                     solution_file: Optional[str] = None) -> dict:
    """Run one sharded train step, one sharded multi-view LM solve and one
    sharded BA on ``n_devices`` spawned ranks (mp=2 when ``n_devices`` is
    even), each checked as the module says; ``batch``: the train step's
    global batch (default 2 per rank).  With ``matches_file`` the ranks
    also run ``solve_file(matches_file, solution_file, use_mesh=True)``
    (rank 0 writes; its seconds and sub_spans under ``solve_file``).
    Returns rank 0's report, with the train step's variables after it
    (``train_variables``) and its gradients (``train_grads``)."""
    from .parallel.multiprocess import run_ranks

    mp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // mp
    batch = batch or n_devices * 2
    reports = run_ranks(_multichip_rank, n_devices,
                        args=(dp, mp, batch, device, matches_file, solution_file), device=device)
    losses = {r["train_loss"] for r in reports}
    _check(len(losses) == 1, f"the ranks' losses differ: {losses}")
    report = reports[0]
    print(
        f"dryrun_multichip OK: mesh dp={dp} mp={mp} ({report['backend']}, {report['device']}), "
        f"train loss {report['train_loss']:.4f} (bf16 {report['train_loss_bf16']:.4f}) at batch "
        f"{batch}, solve batch {tuple(report['solve_batch'])} ({report['solve_edges']} "
        f"edges/component, parity_max_abs {report['solve_parity_max_abs']:.2e} vs 1 rank), "
        f"sharded BA cost {report['ba_cost']:.4f} ({report['ba_rms_px']:.3f} px rms) over "
        f"{report['ba_obs']} obs, parity_max_abs {report['ba_parity_max_abs']:.2e}", flush=True)
    return report


def dryrun_multiprocess(n_processes: int = 2, device="cuda") -> dict:
    """Spawn ``n_processes`` worker processes (``parallel.multiprocess``),
    run the sharded component solve and BA with process-local feeding on
    MULTIPROCESS_SIZES, and hold them to one process on the same problems:
    parity below 1e-3 on the solved camera translations and the first
    component's positions, and the process-boundary efficiency (one
    process's time over N's)."""
    from .parallel.multiprocess import launch

    single = launch(1, device=device, **MULTIPROCESS_SIZES)
    multi = launch(n_processes, device=device, **MULTIPROCESS_SIZES)
    parity = max(float(np.max(np.abs(np.asarray(single[f]) - np.asarray(multi[f]))))
                 for f in ("ba_t", "solve_c0"))
    _check(parity < PARITY_ATOL, f"multi-process parity {parity:.2e} exceeds {PARITY_ATOL}")
    _check(multi["ba_rms_px"] > 0, "the BA problem must be noisy")
    shared = multi["backend"] == "gloo" and multi["device"].startswith("cuda")
    report = {
        "n_processes": n_processes,
        "device": multi["device"],
        "backend": multi["backend"],
        "single_proc_solve_ms": single["solve_ms"],
        "multi_proc_solve_ms": multi["solve_ms"],
        "single_ba_ms": single["ba_ms"],
        "multi_ba_ms": multi["ba_ms"],
        "ba_obs": multi["ba_obs"],
        "ba_rms_px": multi["ba_rms_px"],
        "parity_max_abs": parity,
        "process_boundary_efficiency": single["solve_ms"] / max(multi["solve_ms"], 1e-9),
        "ba_efficiency": single["ba_ms"] / max(multi["ba_ms"], 1e-9),
        "caveat": (
            ("processes sharing one card over gloo (which stages CUDA tensors through the host)"
             if shared else f"processes on {multi['device']} over {multi['backend']}")
            + "; one process drives the same problems alone; measures the process boundary "
            "(collectives, per-process dispatch), not a multi-card or multi-host figure"
        ),
    }
    print("dryrun_multiprocess OK:", json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    device = os.environ.get("DRYRUN_DEVICE", "cuda")
    n = int(os.environ.get("DRYRUN_DEVICES", "0"))
    if n:
        dryrun_multichip(n, device=device)
    n_proc = int(os.environ.get("DRYRUN_PROCESSES", "0"))
    if n_proc:
        report = dryrun_multiprocess(n_proc, device=device)
        out = os.environ.get("DRYRUN_PROCESSES_OUT")
        if out:
            with open(out, "w") as fh:
                json.dump(report, fh)
