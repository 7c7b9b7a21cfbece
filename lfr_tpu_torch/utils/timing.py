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
