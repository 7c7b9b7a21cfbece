"""Build and load the port's host C++ library (``csrc/lfr_native.cc``).

``g++`` compiles the source with the flags of lfr_tpu/native/build.sh into
``lfr_tpu_torch/_build/liblfr_native-<hash>.so``, the hash taken over the
source and the flags, so an edited source rebuilds.  The library has a plain
C interface and is loaded with ``ctypes`` (:mod:`lfr_tpu_torch.solver.native`
binds it).  Nothing is built when a module is imported: the first call
builds.  A failed build raises with g++'s log; no caller falls back to the
numpy routes on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Tuple

from .cuda_build import BUILD_DIR, CSRC

SOURCE = os.path.join(CSRC, "lfr_native.cc")

GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-std=c++17")

_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

#: ctypes signatures of the library's entry points.
SIGNATURES = {
    "lfr_msf_union_find": ((_L, _P, _P, _P, _L, _P, _P), None),
    "lfr_sort_matches_desc": ((_L, _P, _P, _P, _P, _I), None),
    "lfr_counting_argsort": ((_L, _P, _L, _P), None),
    "lfr_matching_count": ((_P, _L, _P, _P, _P), _I),
    "lfr_matching_fill": ((_P, _L, _P, _P, _P, _P, _P, _P, _P), _I),
    "lfr_matching_encode_size": ((_L, _P, _P, _P, _P, _P, _P), _L),
    "lfr_matching_encode": ((_L, _P, _P, _P, _P, _P, _P, _P, _P), _I),
}

_LOADED: Optional[ctypes.CDLL] = None


def gxx_path() -> str:
    found = os.environ.get("CXX") or shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: set CXX or put g++ on PATH")
    return found


def library_path() -> str:
    """Where the library is built: keyed on the hash of source and flags."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"liblfr_native-{digest}.so")


def build() -> Tuple[str, float, str]:
    """Compile unless a library of the same hash exists.  Returns (library
    path, build seconds (0 when reused), g++ log)."""
    lib = library_path()
    if os.path.exists(lib):
        return lib, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([gxx_path(), *GXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}):\n{log}")
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
