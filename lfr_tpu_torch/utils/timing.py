"""Timing spans (port of ``Spans`` and ``Accum`` in lfr_tpu/utils/timing.py)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class Spans:
    """Named, nested wall-clock spans: ``report()`` lists each closed span as
    {"span": "outer/inner", "ms": ...}, in the order they closed."""

    def __init__(self):
        self._spans: List[Dict] = []
        self._stack: List[str] = []

    @contextlib.contextmanager
    def span(self, name: str):
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            self._spans.append({"span": path, "ms": round(dt * 1000.0, 3)})

    def report(self) -> List[Dict]:
        return list(self._spans)


class Accum:
    """Accumulating named sub-spans (total seconds + call counts) for
    attributing time WITHIN one pipeline stage — e.g. how the match-graph
    stage's wall-clock splits across host decode, matcher syncs, CNN
    batches, and proto emission.  Spans here are blocking-time meters on
    an asynchronous pipeline: they sum what the driving thread spent in
    each activity, so they add up to (at most) the stage wall-clock."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.calls[name] = self.calls.get(name, 0) + 1

    def report(self) -> Dict[str, Dict]:
        return {
            k: {"total_s": round(v, 3), "calls": self.calls[k]}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }


class BuildMeter:
    """Cumulative seconds of this process's one-time builds, by kind (the
    port's replacement of the JAX package's ``CompileMeter``, which counts
    XLA's compiles): ``nvcc`` and ``g++`` by the host clock around each
    build (``ops/cuda_build.py``, ``ops/host_build.py``; a reused library
    costs nothing), and ``cudnn_first_call``, the first call of each
    distinct convolution shape on a CUDA device (``models/panet.py``),
    synchronised before and after on that call only: cuDNN's start-up and
    engine choice.  A stage's seconds less its delta of :meth:`seconds`
    are its warm cost."""

    _totals: Dict[str, float] = {}
    _counts: Dict[str, int] = {}
    _seen: set = set()

    @classmethod
    def add(cls, kind: str, seconds: float) -> None:
        cls._totals[kind] = cls._totals.get(kind, 0.0) + seconds
        cls._counts[kind] = cls._counts.get(kind, 0) + 1

    @classmethod
    def first_call(cls, key, device, fn):
        """fn(), timed into ``cudnn_first_call`` the first time ``key`` is
        seen on a CUDA ``device``; untimed (no synchronisation) otherwise."""
        if device.type != "cuda" or key in cls._seen:
            return fn()
        cls._seen.add(key)
        import torch

        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        cls.add("cudnn_first_call", time.perf_counter() - t0)
        return out

    @classmethod
    def seconds(cls, kind: str = None) -> float:
        """Cumulative build seconds so far in this process (of one kind)."""
        if kind is not None:
            return cls._totals.get(kind, 0.0)
        return sum(cls._totals.values())

    @classmethod
    def report(cls) -> Dict[str, Dict]:
        return {k: {"seconds": v, "count": cls._counts[k]} for k, v in sorted(cls._totals.items())}
