"""Build and load the port's CUDA library.

``lfr_tpu_torch/csrc/correlation.cu`` is compiled by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``.  The library goes to
``lfr_tpu_torch/_build/`` under a name keyed on the hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "correlation.cu")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: ctypes signatures of the library's entry points.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "lfr_corr_init": ((), _I),
    "lfr_corr_asym": ((_P, _P, _P, _I, _P), _I),
    "lfr_corr_sym": ((_P, _P, _P, _P, _I, _P), _I),
    "lfr_corr_nonorm": ((_P, _P, _P, _I, _P), _I),
    "lfr_corr_matmul": ((_P, _P, _P, _I, _P), _I),
    "lfr_cuda_error_string": ((_I,), ctypes.c_char_p),
}

_LOADED: Optional[ctypes.CDLL] = None


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


def build() -> Tuple[str, float, str]:
    """Compile the source unless a library of the same source hash exists.
    Returns (library path, build seconds (0 when reused), nvcc log)."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libcorrelation-{digest}.so")
    if os.path.exists(lib):
        return lib, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib, seconds, log


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LOADED
    if _LOADED is None:
        path, _, _ = build()
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED = lib
    return _LOADED


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.lfr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
