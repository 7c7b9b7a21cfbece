"""Accumulating timing spans (port of ``Accum`` in lfr_tpu/utils/timing.py)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict


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
