"""Unified CLI: ``python -m lfr_tpu_torch <command> ...``.

Every stage the port has is one subcommand of one program, sharing the
method registry (lfr_tpu_torch/config.py).  Feature extraction and
incremental SfM come with their slices of the port.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "match": (
        "lfr_tpu_torch.pipelines.match_graph",
        "match graph + two-view CNN refinement -> MatchingFile",
    ),
    "solve": (
        "lfr_tpu_torch.solver.solve",
        "multi-view track solve: MatchingFile -> SolutionFile",
    ),
    "triangulate": (
        "lfr_tpu_torch.pipelines.triangulation",
        "fixed-pose triangulation pipeline (ETH3D layout)",
    ),
    "benchmark": (
        "lfr_tpu_torch.pipelines.benchmark",
        "end-to-end eth benchmark driver (ref & raw A/B)",
    ),
    "dataset": (
        "lfr_tpu_torch.pipelines.dataset_tools",
        "dataset bootstrap: create-db, create-db-eth, match-list, image-list",
    ),
    "compare": (
        "lfr_tpu_torch.eval.compare",
        "compare two reconstructions on commonly registered images",
    ),
}


def _usage() -> str:
    lines = ["usage: python -m lfr_tpu_torch <command> [args...]", "", "commands:"]
    for name, (_, help_text) in COMMANDS.items():
        lines.append(f"  {name:<12} {help_text}")
    lines.append("")
    lines.append("run `python -m lfr_tpu_torch <command> --help` for per-command flags")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    entry = COMMANDS.get(argv[0])
    if entry is None:
        print(f"unknown command {argv[0]!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    importlib.import_module(entry[0]).main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
