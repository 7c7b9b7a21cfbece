"""Several processes on one machine: the worker launcher and the rank
spawner (port of lfr_tpu/parallel/multiprocess.py).

One process drives one device.  This module provides:

- :func:`local_rows`: the rows of a batch axis this process owns (ranks
  in order), which replaces the JAX package's ``put_global``: each process
  uploads only its rows;
- :func:`worker_main`: one worker's entry (``python -m
  lfr_tpu_torch.parallel.multiprocess``): initialise the process group,
  build the mesh, run the sharded component solve and the sharded bundle
  adjustment on deterministic problems, and report their wall clock and
  solved values;
- :func:`launch`: spawn N workers on this machine and return rank 0's
  report; any nonzero exit or a timeout kills the rest and raises;
- :func:`run_ranks`: run a function on N spawned ranks of one process group
  (the dry runs and the tests use it).

With ``device="cuda"`` and one card, the ranks share it over gloo
(``distributed.choose_backend``); the JAX package's ``devices_per_process``
has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def local_rows(global_rows: int, rank: Optional[int] = None, world: Optional[int] = None):
    """Row range [lo, hi) of the batch axis owned by this process: the axis
    (a multiple of ``world``) split evenly over the processes in rank order
    (default: the process group's rank and size, or a world of one)."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    if global_rows % world:
        raise ValueError(f"{global_rows} rows do not split over {world} processes")
    per = global_rows // world
    return rank * per, (rank + 1) * per


def demo_component_batch(global_b: int, n: int = 8, e: int = 24):
    """Deterministic solvable component bucket (global shapes): ``global_b``
    components of ``n`` nodes / ``e`` directed edges; the JAX package's
    ``_demo_component_batch`` (seed 7), the same arrays."""
    from ..solver.lm import ComponentBatch

    rng = np.random.default_rng(7)
    flow = rng.uniform(-0.2, 0.2, (global_b, e, 3, 3, 2)).astype(np.float32)
    esrc = rng.integers(0, n, (global_b, e)).astype(np.int32)
    edst = (esrc + 1 + rng.integers(0, n - 1, (global_b, e))).astype(np.int32) % n
    return ComponentBatch(
        edge_src=esrc,
        edge_dst=edst,
        edge_sim=rng.uniform(0.5, 1.0, (global_b, e)).astype(np.float32),
        edge_flow=flow,
        edge_intra=rng.random((global_b, e)) < 0.7,
        edge_valid=np.ones((global_b, e), bool),
        is_root=np.tile(np.eye(1, n, dtype=bool), (global_b, 1)),
        node_valid=np.ones((global_b, n), bool),
    )


def demo_ba_problem(n_cam: int = 6, n_pts: int = 60, noise_px: float = 0.25):
    """Deterministic dense BA problem (every camera sees every point) with
    observations perturbed by ``noise_px`` so that the converged cost is not
    zero: a wrong sign in a collective would still converge to cost 0 on a
    perfect problem.  The JAX package's ``_demo_ba_problem`` (seed 11), the
    same arrays."""
    from ..sfm import ba as ba_mod

    rng = np.random.default_rng(11)
    f = 500.0
    pts = rng.uniform(-1, 1, (n_pts, 3))
    pts[:, 2] += 6.0
    R = np.tile(np.eye(3), (n_cam, 1, 1))
    t = np.zeros((n_cam, 3))
    t[:, 0] = np.linspace(-0.5, 0.5, n_cam)
    obs_cam = np.repeat(np.arange(n_cam), n_pts)
    obs_pt = np.tile(np.arange(n_pts), n_cam)
    cam_pts = np.einsum("cij,pj->cpi", R, pts) + t[:, None]
    obs_uv = (cam_pts[..., :2] / cam_pts[..., 2:]).reshape(-1, 2)
    obs_uv = obs_uv + rng.normal(0.0, noise_px / f, obs_uv.shape)
    order = np.argsort(obs_pt, kind="stable")
    fixed = np.zeros(n_cam, bool)
    fixed[:2] = True
    return ba_mod.BAProblem(
        R, t, pts + rng.normal(0, 0.01, pts.shape), obs_cam[order], obs_pt[order],
        obs_uv[order], np.full(n_cam * n_pts, f), fixed,
    )


def solve_batch_distributed(batch, mesh, max_iter: int = 25) -> np.ndarray:
    """Sharded component solve with process-local feeding: ``batch`` holds
    global shapes, each process uploads only its rows (``sharded_solve_batch``
    does exactly that here); the full solved array on every process."""
    from .sharded import sharded_solve_batch

    return sharded_solve_batch(batch, mesh, max_iter=max_iter)


# ---------------------------------------------------------------------------
# Spawned ranks of one process group.
# ---------------------------------------------------------------------------


def _backend_flags() -> dict:
    """The caller's TF32 and cuDNN settings, which a spawned rank takes on."""
    import torch

    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_deterministic": torch.backends.cudnn.deterministic}


def _rank_entry(rank, n, port, device, result_dir):
    import torch

    from . import distributed

    # One intra-op thread a rank: the ranks share the host's cores.
    torch.set_num_threads(1)
    with open(os.path.join(result_dir, "call.pkl"), "rb") as fh:
        fn, args, kwargs, flags = pickle.load(fh)
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
    torch.backends.cudnn.benchmark = flags["cudnn_benchmark"]
    torch.backends.cudnn.deterministic = flags["cudnn_deterministic"]
    distributed.initialize(f"127.0.0.1:{port}", n, rank, device=device)
    try:
        result = fn(*args, **kwargs)
        with open(os.path.join(result_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    finally:
        distributed.shutdown()


#: Seconds :func:`run_ranks` waits for its ranks.
RANKS_TIMEOUT_S = 900.0


def run_ranks(fn, n: int, args=(), kwargs=None, device="cuda") -> list:
    """Run ``fn(*args, **kwargs)`` on ``n`` spawned processes that form one
    process group (``distributed.initialize`` on a free local port, the
    backend by ``choose_backend``); returns every rank's result in rank
    order.  ``fn`` must be importable by name (a module-level function).
    A rank that raises or exits nonzero, or a run past RANKS_TIMEOUT_S,
    ends every rank and raises.  Each rank runs one torch thread and takes
    on the caller's TF32 and cuDNN settings."""
    import torch.multiprocessing as mp

    from ..device import resolve_device

    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="lfr_ranks_") as result_dir:
        # The call goes by file: arguments pickled into a spawned process's
        # pipe block its start until the previous process has booted.
        with open(os.path.join(result_dir, "call.pkl"), "wb") as fh:
            pickle.dump((fn, args, kwargs or {}, _backend_flags()), fh)
        context = mp.start_processes(
            _rank_entry, args=(n, free_port(), device, result_dir),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while not context.join(timeout=max(0.1, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                for p in context.processes:
                    if p.is_alive():
                        p.kill()
                for p in context.processes:
                    p.join()
                raise RuntimeError(f"{n} ranks of {fn.__name__} timed out after "
                                   f"{RANKS_TIMEOUT_S} s")
        results = []
        for rank in range(n):
            with open(os.path.join(result_dir, f"rank{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results


# ---------------------------------------------------------------------------
# The worker and its launcher.
# ---------------------------------------------------------------------------


def _split_cores(process_id: int, num_processes: int) -> int:
    """Give this worker a disjoint slice of the cores (a second host brings
    its own); returns the slice's size (0 where affinity is unavailable)."""
    try:
        cores = sorted(os.sched_getaffinity(0))
    except AttributeError:
        return 0
    per = max(1, len(cores) // num_processes)
    mine = cores[process_id * per : (process_id + 1) * per] or cores[:per]
    try:
        os.sched_setaffinity(0, mine)
    except OSError:
        return 0
    return len(mine)


def worker_main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--coordinator", required=True)
    parser.add_argument("--num_processes", type=int, required=True)
    parser.add_argument("--process_id", type=int, required=True)
    parser.add_argument("--global_batch", type=int, default=64)
    parser.add_argument("--iterations", type=int, default=10)
    parser.add_argument("--ba_cams", type=int, default=6)
    parser.add_argument("--ba_pts", type=int, default=60)
    parser.add_argument("--ba_iters", type=int, default=8)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    # Without a core split the N workers' thread pools oversubscribe the
    # host and the measured process-boundary overhead is that instead.
    cores = _split_cores(args.process_id, args.num_processes) if args.num_processes > 1 else 0

    import torch

    from . import distributed
    from .mesh import make_mesh
    from .sharded import run_ba_sharded

    if args.device == "cpu" and cores:
        torch.set_num_threads(cores)
    distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                           device=args.device)
    mesh = make_mesh(dp=args.num_processes, mp=1, device=args.device)

    # --- Sharded component solve, process-local feeding. ------------------
    batch = demo_component_batch(args.global_batch)
    t0 = time.perf_counter()
    out = solve_batch_distributed(batch, mesh, max_iter=args.iterations)
    warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = solve_batch_distributed(batch, mesh, max_iter=args.iterations)
    solve_ms = (time.perf_counter() - t0) * 1e3
    if out.shape[0] != args.global_batch or not np.isfinite(out).all():
        raise RuntimeError(f"distributed solve gave {out.shape}, finite={np.isfinite(out).all()}")

    # --- Sharded BA, each process feeding its points' observations. -------
    prob = demo_ba_problem(args.ba_cams, args.ba_pts)
    t0 = time.perf_counter()
    run_ba_sharded(prob, mesh, iterations=args.ba_iters)
    ba_warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, t_solved, _, _, cost = run_ba_sharded(prob, mesh, iterations=args.ba_iters)
    ba_ms = (time.perf_counter() - t0) * 1e3
    rms = float(np.sqrt(2 * cost / prob.obs_cam.shape[0]))
    if not np.isfinite(cost):
        raise RuntimeError("distributed BA diverged")

    report = {
        "num_processes": args.num_processes,
        "process_id": args.process_id,
        "global_devices": mesh.size,
        "device": str(mesh.device),
        "backend": mesh.backend,
        "solve_ms": solve_ms,
        "solve_warm_ms": warm_ms,
        "ba_ms": ba_ms,
        "ba_warm_ms": ba_warm_ms,
        "ba_obs": int(prob.obs_cam.shape[0]),
        "ba_rms_px": rms,
        # Solved-value fingerprints, so that the launcher can hold the
        # 1-process and N-process runs to the same numbers.
        "ba_t": np.asarray(t_solved, np.float64).ravel().tolist(),
        "solve_c0": np.asarray(out[0], np.float64).ravel().tolist(),
    }
    print(json.dumps(report), flush=True)
    if args.out and args.process_id == 0:
        with open(args.out, "w") as fh:
            json.dump(report, fh)
    distributed.shutdown()


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def launch(
    num_processes: int,
    device="cuda",
    global_batch: int = 64,
    iterations: int = 10,
    ba_cams: int = 6,
    ba_pts: int = 60,
    ba_iters: int = 8,
    timeout: float = 600.0,
    out: Optional[str] = None,
) -> dict:
    """Spawn ``num_processes`` workers (``python -m
    lfr_tpu_torch.parallel.multiprocess``) on this machine and return
    process 0's report.  Raises, and kills the rest, as soon as a worker
    exits nonzero or the run passes ``timeout`` seconds."""
    from ..device import resolve_device

    resolve_device(device)
    port = free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="lfr_mp_") as tmp:
        report_path = out or os.path.join(tmp, "report.json")
        procs, logs = [], []
        for pid in range(num_processes):
            cmd = [
                sys.executable, "-m", "lfr_tpu_torch.parallel.multiprocess",
                "--coordinator", f"127.0.0.1:{port}",
                "--num_processes", str(num_processes),
                "--process_id", str(pid),
                "--global_batch", str(global_batch),
                "--iterations", str(iterations),
                "--ba_cams", str(ba_cams),
                "--ba_pts", str(ba_pts),
                "--ba_iters", str(ba_iters),
                "--device", str(device),
                "--out", report_path,
            ]
            log = open(os.path.join(tmp, f"worker{pid}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(cmd, cwd=repo_root, stdout=log,
                                          stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    _kill(procs)
                    i = failed[0]
                    logs[i].seek(0)
                    raise RuntimeError(f"worker {i} rc={codes[i]}:\n{logs[i].read()[-2000:]}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    _kill(procs)
                    raise RuntimeError(f"multiprocess workers timed out after {timeout} s")
                time.sleep(0.05)
        finally:
            _kill(procs)
            for log in logs:
                log.close()
        with open(report_path) as fh:
            return json.load(fh)


if __name__ == "__main__":
    worker_main()
