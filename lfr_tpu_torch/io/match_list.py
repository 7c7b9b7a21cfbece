"""Match-list generation and parsing (copy of lfr_tpu/io/match_list.py).

A match list is a text file with one ``name1 name2`` pair per line
(reference: utils/create_exhaustive_matching_list.py:31-39,
utils/create_sequential_matching_list.py:36-49).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple


def read_match_list(path: str) -> List[Tuple[str, str]]:
    pairs = []
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            name1, name2 = line.split(" ")
            pairs.append((name1, name2))
    return pairs


def write_match_list(path: str, pairs: Sequence[Tuple[str, str]]) -> None:
    with open(path, "w") as fh:
        for name1, name2 in pairs:
            fh.write(f"{name1} {name2}\n")


def exhaustive_pairs(images: Sequence[str]) -> List[Tuple[str, str]]:
    """All ordered pairs (i < j), preserving input order."""
    out = []
    for i in range(len(images)):
        for j in range(i + 1, len(images)):
            out.append((images[i], images[j]))
    return out


def sequential_pairs(images: Sequence[str], num_frames: int = 3) -> List[Tuple[str, str]]:
    """Pairs whose frame indices (parsed from ``NNN-*.ext`` basenames) are at
    most ``num_frames`` apart (reference: create_sequential_matching_list.py:39-47).

    Names without the reference's ``NNN-`` prefix fall back to their
    position in the given (caller-sorted) order."""
    out = []

    def _frame(i: int, name: str) -> int:
        head = os.path.split(name)[1].split("-")[0]
        return int(head) if head.isdigit() else i

    frame_idx = [_frame(i, name) for i, name in enumerate(images)]
    for i in range(len(images)):
        for j in range(i + 1, len(images)):
            if frame_idx[j] - frame_idx[i] > num_frames:
                continue
            out.append((images[i], images[j]))
    return out
