"""Cross-pair streaming refinement: fixed-size CNN batches over many pairs
(port of lfr_tpu/pipelines/stream.py).

Matches from MANY pairs stream into refinement batches of ``refine_batch``
rows against device-resident image *stacks*:

  per P pairs: one batched matcher launch over a device descriptor stack
               -> packed (nn, sim, keep), one copy to the host
  per batch:   one coarse+fine CNN pass over (S, H, W, 3) image stacks with
               per-match image indices, so pairs with few matches never
               leave the CNN batch half empty.

Pair results are emitted in submission order; every match of every pair is
refined.  The stacks are preallocated tensors whose slots are written in
place.  Results come back through pinned host buffers copied asynchronously
and waited on by event, so up to ``MATCH_DEPTH`` matcher launches and
``REFINE_DEPTH`` refinement batches stay in flight while the host prepares
the next.  A short last batch runs at its own size (the JAX package pads it
to a power-of-two bucket for its compile cache; the rows are independent, so
the results are the same).
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops.matchers import _pad_descriptors
from ..utils.timing import Accum

#: Matches per refinement batch.
REFINE_BATCH = 2048

#: In-flight batched matcher launches before the oldest is waited on.
MATCH_DEPTH = 2

#: In-flight refinement batches before the oldest is waited on.
REFINE_DEPTH = 2

#: Device bytes for the two image stacks together.  An eviction drains all
#: in-flight work, so a stack smaller than the working set of images
#: thrashes; at 1067x1600 one image takes 137.6 MB (27.5 MB base level,
#: 110 MB 2x level), so 4 GB hold 29 images.
STACK_BUDGET_BYTES = int(4e9)

#: Device bytes for the descriptor stack.
DESC_BUDGET_BYTES = int(512e6)


def _match_pairs_for(bucket: int) -> int:
    """Pairs per batched matcher launch at descriptor bucket B (bounded by
    the (P, B, B) similarity volume; 32 pairs at B=2048 is 512 MB)."""
    return int(max(2, min(32, (1 << 31) // max(bucket * bucket * 4, 1))))


class _HostCopy:
    """A device result on its way to host memory: a CUDA tensor is copied
    into a pinned buffer without blocking and :meth:`get` waits for that copy
    alone, not for the work enqueued after it."""

    def __init__(self, tensor: torch.Tensor):
        self.event = None
        if tensor.is_cuda:
            self.host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self.host.copy_(tensor, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = tensor

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _PairRec:
    __slots__ = ("meta", "matches", "sims", "grid12", "grid21", "remaining", "matched")

    def __init__(self, meta):
        self.meta = meta
        self.matches = None
        self.sims = None
        self.grid12 = None
        self.grid21 = None
        self.remaining = -1
        self.matched = False


#: Per-row columns of the accumulated matches, in the order they are packed
#: into one (N, 10) f32 array for the copy to the device: centers (i, j) in
#: both images at matching resolution, stack slots, and the slots' margin
#: offsets at the base and 2x levels.
_COLUMNS = ("ij1", "ij2", "k1", "k2", "ob1", "ob2", "ou1", "ou2")


class MatchRefineStream:
    """Streams (match -> batch-refine) over a sequence of image pairs.

    Usage (see pipelines.match_graph):
        stream.add_pair(meta, name1, prep1, kps1, d1, name2, prep2, kps2, d2,
                        matcher, threshold)
        for meta, payload in stream.ready():   # completed pairs, in order
            ...
        for meta, payload in stream.flush():   # at end of the pair list
            ...
    """

    def __init__(
        self,
        refiner,
        refine_batch: int = REFINE_BATCH,
        stack_budget_bytes: int = STACK_BUDGET_BYTES,
        accum: Optional[Accum] = None,
    ):
        self.refiner = refiner
        self.device = refiner.device
        self.refine_batch = int(refine_batch)
        self.stack_budget = int(stack_budget_bytes)
        #: Blocking-time attribution of the streaming pipeline (shared
        #: with the caller's match-graph breakdown when provided).
        self.accum = accum if accum is not None else Accum()

        self._base_stack: Optional[torch.Tensor] = None  # (S, Hb, Wb, 3)
        self._up_stack: Optional[torch.Tensor] = None    # (S, Hu, Wu, 3)
        self._slots: "collections.OrderedDict[str, int]" = collections.OrderedDict()
        self._free: List[int] = []
        self._off_base: Optional[np.ndarray] = None
        self._off_up: Optional[np.ndarray] = None

        # Host-side accumulation of matches awaiting refinement.
        self._acc: Dict[str, List[np.ndarray]] = {k: [] for k in _COLUMNS}
        self._acc_rows = 0
        #: CNN-refined rows (= MNN matches before any geometric verification).
        self.refined_rows = 0
        #: (pair_rec, start_row_in_pair, n_rows) segments per accum row run.
        self._acc_segments: List[Tuple[_PairRec, int, int]] = []

        self._pairs: "collections.deque[_PairRec]" = collections.deque()
        #: Pairs awaiting a batched matcher launch.
        self._pend_match: List[tuple] = []
        #: In-flight matcher batches: (host copy, [per-pair meta, ...]).
        self._match_q: "collections.deque[tuple]" = collections.deque()
        #: In-flight refinement batches: (host copy, segments, rows).
        self._refine_q: "collections.deque[tuple]" = collections.deque()

        # Device descriptor stack: each image's padded descriptors upload
        # once and P pairs match by slot index in one launch.
        self._dstack: Optional[torch.Tensor] = None  # (S, B, D)
        self._dslots: "collections.OrderedDict[str, int]" = collections.OrderedDict()
        self._dhost: Dict[str, tuple] = {}  # name -> (padded np, n_valid)
        self._dfree: List[int] = []
        self._dn: Optional[np.ndarray] = None  # (S,) valid counts

    # ------------------------------------------------------------------
    # Image stack
    # ------------------------------------------------------------------

    def _alloc_stacks(self, base_shape, up_shape) -> None:
        bytes_per = int(np.prod(base_shape) + np.prod(up_shape)) * 4
        s = max(4, min(256, self.stack_budget // max(bytes_per, 1)))
        self._base_stack = self._up_stack = None  # free the old stacks first
        self._base_stack = torch.zeros((s,) + tuple(base_shape), dtype=torch.float32,
                                       device=self.device)
        self._up_stack = torch.zeros((s,) + tuple(up_shape), dtype=torch.float32,
                                     device=self.device)
        self._slots.clear()
        self._free = list(range(s))
        self._off_base = np.zeros(s, np.float32)
        self._off_up = np.zeros(s, np.float32)

    @staticmethod
    def _write_slot(stack: torch.Tensor, slot: int, arr: torch.Tensor) -> None:
        """Write one image into its slot in place, zero-extended to the
        slot's shape.  On one CUDA stream the write is ordered after the
        batches already enqueued that read the slot."""
        view = stack[slot]
        if arr.shape != view.shape:
            view.zero_()
            view = view[: arr.shape[0], : arr.shape[1]]
        view.copy_(arr)

    def _ensure_slot(self, name: str, prep) -> int:
        if name in self._slots:
            self._slots.move_to_end(name)
            return self._slots[name]

        base_shape, up_shape = tuple(prep.base.array.shape), tuple(prep.up.array.shape)
        if self._base_stack is None:
            self._alloc_stacks(base_shape, up_shape)
        elif (
            base_shape[0] > self._base_stack.shape[1]
            or base_shape[1] > self._base_stack.shape[2]
            or up_shape[0] > self._up_stack.shape[1]
            or up_shape[1] > self._up_stack.shape[2]
        ):
            # A larger image arrived: finish all in-flight work referencing
            # the old stacks, then grow.
            self._drain_all_device_work()
            self._alloc_stacks(
                (max(base_shape[0], self._base_stack.shape[1]),
                 max(base_shape[1], self._base_stack.shape[2]), 3),
                (max(up_shape[0], self._up_stack.shape[1]),
                 max(up_shape[1], self._up_stack.shape[2]), 3),
            )

        if not self._free:
            # Evict the least-recently-used image.  The accumulated rows and
            # in-flight batches carry this slot's index and host-side
            # offsets, so they complete first.
            self._drain_all_device_work()
            _, slot = self._slots.popitem(last=False)
            self._free.append(slot)

        slot = self._free.pop()
        self._write_slot(self._base_stack, slot, prep.base.array)
        self._write_slot(self._up_stack, slot, prep.up.array)
        self._off_base[slot] = prep.base.offset
        self._off_up[slot] = prep.up.offset
        self._slots[name] = slot
        return slot

    # ------------------------------------------------------------------
    # Descriptor stack
    # ------------------------------------------------------------------

    def _alloc_dstack(self, rows: int, dim: int) -> None:
        bytes_per = rows * dim * 4
        s = max(4, min(1024, DESC_BUDGET_BYTES // max(bytes_per, 1)))
        self._dstack = None
        self._dstack = torch.zeros((s, rows, dim), dtype=torch.float32, device=self.device)
        self._dslots.clear()
        self._dfree = list(range(s))
        self._dn = np.zeros(s, np.int32)

    def _finish_matching(self) -> None:
        self._dispatch_match()
        while self._match_q:
            self._sync_one_match()

    def _ensure_desc_slot(self, name: str, desc: np.ndarray) -> int:
        if name in self._dslots:
            self._dslots.move_to_end(name)
            return self._dslots[name]

        padded, n = _pad_descriptors(np.asarray(desc, np.float32))
        if self._dstack is None:
            self._alloc_dstack(padded.shape[0], padded.shape[1])
        elif padded.shape[0] > self._dstack.shape[1] or padded.shape[1] > self._dstack.shape[2]:
            # A larger descriptor block arrived: finish in-flight matcher
            # work, grow the stack, and re-upload the live slots.
            self._finish_matching()
            live = list(self._dslots.keys())
            self._alloc_dstack(
                max(padded.shape[0], self._dstack.shape[1]),
                max(padded.shape[1], self._dstack.shape[2]),
            )
            for other in live:
                if other in self._dhost:
                    self._upload_desc(other, *self._dhost[other])
        if not self._dfree:
            # Evict the least-recently-used descriptors.  Pending pairs hold
            # slot indices, so their batch must launch and finish first.
            self._finish_matching()
            old, slot = self._dslots.popitem(last=False)
            self._dhost.pop(old, None)
            self._dfree.append(slot)
        return self._upload_desc(name, padded, n)

    def _upload_desc(self, name: str, padded: np.ndarray, n: int) -> int:
        slot = self._dfree.pop()
        sh = tuple(self._dstack.shape[1:])
        if padded.shape != sh:
            block = np.zeros(sh, np.float32)
            block[: padded.shape[0], : padded.shape[1]] = padded
            padded = block
        self._dstack[slot].copy_(torch.from_numpy(padded))
        self._dn[slot] = n
        self._dslots[name] = slot
        self._dhost[name] = (padded, n)
        return slot

    # ------------------------------------------------------------------
    # Pair intake
    # ------------------------------------------------------------------

    def add_pair(
        self,
        meta,
        name1: str, prep1, kps1: np.ndarray, desc1: np.ndarray,
        name2: str, prep2, kps2: np.ndarray, desc2: np.ndarray,
        matcher: str, threshold: float,
    ) -> None:
        rec = _PairRec(meta)
        self._pairs.append(rec)

        # Ensure BOTH slots, then re-resolve: ensuring the second image can
        # grow or LRU-evict the stack, invalidating the first slot index.
        with self.accum.span("stack_upload"):
            self._ensure_slot(name1, prep1)
            self._ensure_slot(name2, prep2)
            if name1 not in self._slots:
                self._ensure_slot(name1, prep1)  # re-upload; LRU spares name2
        slot1 = self._slots[name1]
        slot2 = self._slots[name2]

        kind = "similarity" if matcher == "similarity" else "ratio"
        if self._pend_match and self._pend_match[0][1] != kind:
            self._dispatch_match()  # one matcher kind per launch
        with self.accum.span("desc_upload"):
            self._ensure_desc_slot(name1, desc1)
            self._ensure_desc_slot(name2, desc2)
            if name1 not in self._dslots:
                self._ensure_desc_slot(name1, desc1)
        d1 = self._dslots[name1]
        d2 = self._dslots[name2]
        self._pend_match.append((rec, kind, d1, d2, float(threshold), kps1, kps2, slot1, slot2))
        if len(self._pend_match) >= _match_pairs_for(self._dstack.shape[1]):
            self._dispatch_match()

    def add_empty_pair(self, meta) -> None:
        """Queue a pair with no features/matches (keeps emission order)."""
        rec = _PairRec(meta)
        rec.matches = np.zeros((0, 2), np.int64)
        rec.sims = np.zeros(0, np.float32)
        rec.grid12 = np.zeros((0, 3, 3, 2), np.float32)
        rec.grid21 = np.zeros((0, 3, 3, 2), np.float32)
        rec.remaining = 0
        rec.matched = True
        self._pairs.append(rec)

    def _dispatch_match(self) -> None:
        group, self._pend_match = self._pend_match, []
        if not group:
            return
        with self.accum.span("match_dispatch"):
            s1 = np.array([g[2] for g in group], np.int64)
            s2 = np.array([g[3] for g in group], np.int64)
            n1 = self._dn[s1].copy()
            n2 = self._dn[s2].copy()
            thr = np.array([g[4] for g in group], np.float32)
            dev = self.device
            packed = self.refiner._match_stack(
                self._dstack,
                torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev),
                torch.from_numpy(n1).to(dev), torch.from_numpy(n2).to(dev),
                torch.from_numpy(thr).to(dev),
                matcher=group[0][1],
            )
            metas = [(g[0], int(n1[i]), g[5], g[6], g[7], g[8]) for i, g in enumerate(group)]
            self._match_q.append((_HostCopy(packed), metas))
        while len(self._match_q) > MATCH_DEPTH:
            self._sync_one_match()

    def _sync_one_match(self) -> None:
        copy, metas = self._match_q.popleft()
        with self.accum.span("match_sync"):
            packed_all = copy.get()  # (P, B, 3): one copy per batch
        with self.accum.span("match_ingest"):
            for row, meta in zip(packed_all, metas):
                self._ingest_match(row, *meta)

    def _ingest_match(self, packed, rec, n1, kps1, kps2, slot1, slot2) -> None:
        keep = packed[:n1, 2] > 0
        idx1 = np.nonzero(keep)[0]
        idx2 = packed[idx1, 0].astype(np.int64)
        sims = packed[idx1, 1].astype(np.float32)
        m = idx1.shape[0]

        rec.matches = np.stack([idx1, idx2], axis=1) if m else np.zeros((0, 2), np.int64)
        rec.sims = sims
        rec.grid12 = np.zeros((m, 3, 3, 2), np.float32)
        rec.grid21 = np.zeros((m, 3, 3, 2), np.float32)
        rec.remaining = m
        rec.matched = True
        if m == 0:
            return

        # (row, col) centers at matching resolution.
        self._acc["ij1"].append(kps1[idx1][:, 1::-1].astype(np.float32))
        self._acc["ij2"].append(kps2[idx2][:, 1::-1].astype(np.float32))
        self._acc["k1"].append(np.full((m, 1), slot1, np.float32))
        self._acc["k2"].append(np.full((m, 1), slot2, np.float32))
        self._acc["ob1"].append(np.full((m, 1), self._off_base[slot1], np.float32))
        self._acc["ob2"].append(np.full((m, 1), self._off_base[slot2], np.float32))
        self._acc["ou1"].append(np.full((m, 1), self._off_up[slot1], np.float32))
        self._acc["ou2"].append(np.full((m, 1), self._off_up[slot2], np.float32))
        self._acc_segments.append((rec, 0, m))
        self._acc_rows += m

        while self._acc_rows >= self.refine_batch:
            self._dispatch_refine(self.refine_batch)

    # ------------------------------------------------------------------
    # Refinement batches
    # ------------------------------------------------------------------

    def _take_rows(self, want: int):
        """Pop exactly ``want`` accumulated rows (splitting segments)."""
        taken = {k: [] for k in self._acc}
        segs: List[Tuple[_PairRec, int, int]] = []
        got = 0
        while got < want and self._acc_segments:
            rec, start, n = self._acc_segments[0]
            take = min(n, want - got)
            for k in self._acc:
                arr = self._acc[k][0]
                taken[k].append(arr[:take])
                if take == arr.shape[0]:
                    self._acc[k].pop(0)
                else:
                    self._acc[k][0] = arr[take:]
            segs.append((rec, start, take))
            if take == n:
                self._acc_segments.pop(0)
            else:
                self._acc_segments[0] = (rec, start + take, n - take)
            got += take
        self._acc_rows -= got
        cols = np.concatenate([np.concatenate(taken[k]) for k in _COLUMNS], axis=1) if got else None
        return cols, segs, got

    def _dispatch_refine(self, batch_rows: int) -> None:
        with self.accum.span("refine_dispatch"):
            cols, segs, got = self._take_rows(batch_rows)
            if got == 0:
                return
            self.refined_rows += got
            c = torch.from_numpy(cols).to(self.device)  # (got, 10): one copy
            g12, g21 = self.refiner._refine_batch(
                self._base_stack, self._up_stack,
                c[:, 4].long(), c[:, 5].long(),
                c[:, 0:2], c[:, 2:4],
                c[:, 6], c[:, 7], c[:, 8], c[:, 9],
            )
            packed = torch.cat([g12.reshape(-1, 18), g21.reshape(-1, 18)], dim=1)
            self._refine_q.append((_HostCopy(packed), segs, got))
        while len(self._refine_q) > REFINE_DEPTH:
            self._sync_one_refine()

    def _sync_one_refine(self) -> None:
        copy, segs, got = self._refine_q.popleft()
        with self.accum.span("refine_sync"):
            packed = copy.get()  # (got, 36)
        row = 0
        for rec, start, n in segs:
            block = packed[row : row + n]
            rec.grid12[start : start + n] = block[:, :18].reshape(-1, 3, 3, 2)
            rec.grid21[start : start + n] = block[:, 18:].reshape(-1, 3, 3, 2)
            rec.remaining -= n
            row += n

    def _drain_all_device_work(self) -> None:
        self._finish_matching()
        while self._acc_rows:
            self._dispatch_refine(min(self._acc_rows, self.refine_batch))
        while self._refine_q:
            self._sync_one_refine()

    # ------------------------------------------------------------------
    # Output
    # ------------------------------------------------------------------

    def _pop_complete(self) -> Iterator[Tuple[object, tuple]]:
        while self._pairs and self._pairs[0].matched and self._pairs[0].remaining == 0:
            rec = self._pairs.popleft()
            yield rec.meta, (rec.matches, rec.sims, rec.grid12, rec.grid21)

    def ready(self) -> Iterator[Tuple[object, tuple]]:
        """Completed pairs in submission order (waits only on batches beyond
        the pipeline depth)."""
        yield from self._pop_complete()

    def flush(self) -> Iterator[Tuple[object, tuple]]:
        """Finish everything and yield all remaining pairs in order."""
        self._drain_all_device_work()
        yield from self._pop_complete()

    def close(self) -> None:
        """Drop the device stacks, so that their memory is free for what
        runs next."""
        self._base_stack = self._up_stack = self._dstack = None
        self._slots.clear()
        self._dslots.clear()
        self._dhost.clear()
        self._free = []
        self._dfree = []
