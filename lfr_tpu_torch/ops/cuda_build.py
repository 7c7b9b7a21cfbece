"""Build and load the port's CUDA libraries.

Each source ``lfr_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into a
shared library of its own with a plain C interface (no PyTorch headers, so
a build takes seconds) and loaded with ``ctypes``:

- ``correlation.cu``: the correlation kernels (:mod:`.correlation`);
- ``nn_dist.cu``: the nearest-neighbour distance kernel (:mod:`.nn_dist`).

A library goes to ``lfr_tpu_torch/_build/lib<name>-<hash>.so``, the hash
taken over that source and the flags alone, so an edited source rebuilds
its own library and leaves the others' names, and so their builds, as they
were.  Nothing is built when a module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

from ..utils.timing import BuildMeter

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: The correlation library's source (scripts/ablate_torch_corr.py builds
#: patched copies of it).
SOURCE = os.path.join(CSRC, "correlation.cu")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: ctypes signatures of the correlation library's entry points.
SIGNATURES = {
    "lfr_corr_init": ((), _I),
    "lfr_corr_asym": ((_P, _P, _P, _I, _P), _I),
    "lfr_corr_sym": ((_P, _P, _P, _P, _I, _P), _I),
    "lfr_corr_nonorm": ((_P, _P, _P, _I, _P), _I),
    "lfr_corr_matmul": ((_P, _P, _P, _I, _P), _I),
    "lfr_cuda_error_string": ((_I,), ctypes.c_char_p),
}

#: Library name -> ctypes signatures of its entry points.
LIBRARIES = {
    "correlation": SIGNATURES,
    "nn_dist": {
        "lfr_nn_min_sq": ((_P, _P, _L, _L, _P, _I, _L, _P), _I),
        "lfr_cuda_error_string": ((_I,), ctypes.c_char_p),
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str = "correlation") -> str:
    """Where the library of source ``name`` is built: keyed on the hash of
    that source and the flags."""
    with open(source_path(name), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str = "correlation") -> Tuple[str, float, str]:
    """Compile source ``name`` unless a library of the same hash exists.
    Returns (library path, build seconds (0 when reused), nvcc log)."""
    lib = library_path(name)
    if os.path.exists(lib):
        return lib, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = source_path(name)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    BuildMeter.add("nvcc", seconds)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib, seconds, log


def build_all() -> Dict[str, Tuple[str, float, str]]:
    """Build every library at once, one ``nvcc`` per source started
    together; returns name -> (library path, seconds, nvcc log)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        futures = {name: pool.submit(build, name) for name in LIBRARIES}
        return {name: fut.result() for name, fut in futures.items()}


def library(name: str = "correlation") -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    if name not in _LOADED:
        path, _, _ = build(name)
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in LIBRARIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return _LOADED[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.lfr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
