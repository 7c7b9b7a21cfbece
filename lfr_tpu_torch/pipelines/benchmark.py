"""Benchmark driver (port of lfr_tpu/pipelines/benchmark.py): match graph,
multi-view solve, then per run (refined ``ref`` beside unrefined ``raw``)
either fixed-pose triangulation and evaluation of an ETH3D-layout scene
(``eth``) or incremental SfM (``lfe``, ``custom``).

    python -m lfr_tpu_torch.pipelines.benchmark eth --dataset_path D \\
        --method_name sift --checkpoint weights/panet_holdout.msgpack \\
        [--output_path output] [--no_eval] [--fine_mode grid] [--device cpu]
    python -m lfr_tpu_torch.pipelines.benchmark custom --dataset_path D \\
        --method_name sift --checkpoint weights/panet_holdout.msgpack \\
        [--output_path output] [--fine_mode grid] [--device cpu]

With ``SKIP_REFINEMENT`` in the environment only ``raw`` runs, with zero
flow grids and no solve.  Without it a checkpoint is required: the port has
no randomly initialised network.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from ..config import get_method
from ..device import resolve_device
from ..solver import solve as solve_mod
from ..utils.timing import Spans
from . import match_graph as mg_mod
from . import reconstruction as rec_pipeline
from . import triangulation as tri_pipeline


def _refiner(checkpoint, fine_mode, batch_size, dev, caller):
    if not checkpoint:
        raise ValueError(
            f"{caller} needs PANet weights (checkpoint=weights/panet_*.msgpack) "
            "or skip_refinement=True"
        )
    from ..models.checkpoint import load_variables
    from .refinement import TwoViewRefiner

    kwargs = {"batch_size": batch_size} if batch_size else {}
    return TwoViewRefiner(load_variables(checkpoint), fine_mode=fine_mode, device=dev, **kwargs)


def run_eth(
    dataset_path: str,
    method_name: str,
    output_path: str = "output",
    skip_refinement: bool = False,
    checkpoint: Optional[str] = None,
    refiner=None,
    evaluate: bool = True,
    batch_size: int = None,
    verbose: bool = True,
    fine_mode: str = "grid",
    device="cuda",
) -> dict:
    """ETH3D triangulation benchmark of one dataset.

    Writes ``<method>-<dataset>-{matches,solution}.pb``, the evaluation
    text files ``<method>-<dataset>-{ref,raw}.txt`` and
    ``<method>-<dataset>-stats.json`` under ``output_path``, and the models
    into the dataset.  Returns {"ref", "raw": triangulation stats with their
    "evaluation", "timing": the spans (``match_graph``, ``solve``,
    ``triangulation_<tag>`` and ``evaluation_<tag>`` with its ``scan``,
    ``visibility`` and ``nn``), "match_graph_breakdown"}."""
    dev = resolve_device(device)
    method = get_method(method_name)
    dataset_name = os.path.basename(os.path.normpath(dataset_path))
    os.makedirs(output_path, exist_ok=True)

    matches_file = os.path.join(output_path, f"{method_name}-{dataset_name}-matches.pb")
    solution_file = os.path.join(output_path, f"{method_name}-{dataset_name}-solution.pb")
    scan_file = os.path.join(dataset_path, "dslr_scan_eval", "scan_alignment.mlp")

    if refiner is None and not skip_refinement:
        refiner = _refiner(checkpoint, fine_mode, batch_size, dev, "run_eth")

    spans = Spans()
    mg_breakdown: dict = {}
    with spans.span("match_graph"):
        mg_mod.compute_match_graph(
            os.path.join(dataset_path, "images"),
            os.path.join(dataset_path, "match-list.txt"),
            method,
            matches_file,
            refiner=refiner,
            skip_refinement=skip_refinement,
            progress=verbose,
            sub_spans=mg_breakdown,
            device=dev,
        )

    if not skip_refinement:
        with spans.span("solve"):
            solve_mod.solve_file(matches_file, solution_file, device=dev, verbose=verbose)

    results = {}
    runs = [("raw", None)] if skip_refinement else [("ref", solution_file), ("raw", None)]
    for tag, sol in runs:
        with spans.span(f"triangulation_{tag}"):
            stats = tri_pipeline.triangulation_pipeline(
                dataset_path, method_name, matches_file, sol, verbose=verbose, device=dev
            )
        results[tag] = stats
        ply = os.path.join(dataset_path, f"sparse-{method_name}-{tag}.ply")
        if evaluate and os.path.exists(scan_file):
            from ..eval import eth3d

            with spans.span(f"evaluation_{tag}"):
                # Completeness counts the scan samples visible in the
                # ground-truth views.
                ev = eth3d.evaluate_ply(
                    ply,
                    scan_file,
                    gt_model_path=os.path.join(dataset_path, "dslr_calibration_undistorted"),
                    device=dev,
                    spans=spans,
                )
            results[tag]["evaluation"] = ev
            out_txt = os.path.join(output_path, f"{method_name}-{dataset_name}-{tag}.txt")
            with open(out_txt, "w") as fh:
                fh.write(eth3d.format_results(ev))

    results["timing"] = spans.report()
    results["match_graph_breakdown"] = mg_breakdown
    with open(os.path.join(output_path, f"{method_name}-{dataset_name}-stats.json"), "w") as fh:
        json.dump(results, fh, indent=2)
    return results


def run_sfm(
    dataset_path: str,
    method_name: str,
    output_path: str = "output",
    skip_refinement: bool = False,
    checkpoint: Optional[str] = None,
    refiner=None,
    batch_size: int = None,
    verbose: bool = True,
    fine_mode: str = "grid",
    matches_file: Optional[str] = None,
    solution_file: Optional[str] = None,
    device="cuda",
) -> dict:
    """Full-SfM benchmark of one dataset, the LFE / custom path (reference:
    local-feature-evaluation/benchmark.py:85-126, custom_demo.py:87-126).

    ``matches_file`` / ``solution_file``: existing files to reuse (the
    reference computes the match graph once per scene and feeds the same
    files to every later stage).  A given ``matches_file`` is only read:
    without ``solution_file`` (and with refinement) the solve runs on it and
    writes ``<method>-<dataset>-solution.pb`` under ``output_path``.  (The
    JAX package computes the match graph again over the caller's file.)
    Writes ``<method>-<dataset>-{ref,raw}.json`` (two JSON lines: matching,
    reconstruction) and ``<method>-<dataset>-stats.json`` under
    ``output_path`` and the models into the dataset.  Returns {"ref", "raw":
    the reconstruction pipeline's stats, "timing": the spans
    (``match_graph``, ``solve``, ``reconstruction_<tag>``),
    "match_graph_breakdown"}."""
    dev = resolve_device(device)
    method = get_method(method_name)
    dataset_name = os.path.basename(os.path.normpath(dataset_path))
    os.makedirs(output_path, exist_ok=True)

    compute_matches = matches_file is None
    if compute_matches:
        matches_file = os.path.join(output_path, f"{method_name}-{dataset_name}-matches.pb")
    solve = solution_file is None and not skip_refinement
    if solve:
        solution_file = os.path.join(output_path, f"{method_name}-{dataset_name}-solution.pb")
        if os.path.abspath(solution_file) == os.path.abspath(matches_file):
            raise ValueError(f"the solution would overwrite the matches file {matches_file}")

    spans = Spans()
    mg_breakdown: dict = {}
    if compute_matches:
        if refiner is None and not skip_refinement:
            refiner = _refiner(checkpoint, fine_mode, batch_size, dev, "run_sfm")
        with spans.span("match_graph"):
            mg_mod.compute_match_graph(
                os.path.join(dataset_path, "images"),
                os.path.join(dataset_path, "match-list.txt"),
                method,
                matches_file,
                refiner=refiner,
                skip_refinement=skip_refinement,
                progress=verbose,
                sub_spans=mg_breakdown,
                device=dev,
            )
    if solve:
        with spans.span("solve"):
            solve_mod.solve_file(matches_file, solution_file, device=dev, verbose=verbose)

    results = {}
    runs = [("raw", None)] if skip_refinement else [("ref", solution_file), ("raw", None)]
    for tag, sol in runs:
        out_json = os.path.join(output_path, f"{method_name}-{dataset_name}-{tag}.json")
        with spans.span(f"reconstruction_{tag}"):
            results[tag] = rec_pipeline.reconstruction_pipeline(
                dataset_path, method_name, matches_file, sol, out_json, verbose=verbose,
                device=dev,
            )
    results["timing"] = spans.report()
    results["match_graph_breakdown"] = mg_breakdown
    with open(os.path.join(output_path, f"{method_name}-{dataset_name}-stats.json"), "w") as fh:
        json.dump(results, fh, indent=2)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="lfr_tpu_torch benchmark driver")
    sub = parser.add_subparsers(dest="command", required=True)

    p_eth = sub.add_parser("eth", help="ETH3D triangulation benchmark")
    p_eth.add_argument("--dataset_path", required=True)
    p_eth.add_argument("--method_name", required=True)
    p_eth.add_argument("--output_path", default="output")
    p_eth.add_argument(
        "--checkpoint", default=None,
        help="PANet weights as msgpack (weights/panet_*.msgpack); required "
        "unless SKIP_REFINEMENT is set",
    )
    p_eth.add_argument("--no_eval", action="store_true")
    p_eth.add_argument("--fine_mode", default="grid", choices=["grid", "crop"])
    parsers = [p_eth]
    for name, helptext in [
        ("lfe", "local-feature-evaluation SfM benchmark"),
        ("custom", "custom-dataset SfM benchmark"),
    ]:
        p = sub.add_parser(name, help=helptext)
        p.add_argument("--dataset_path", required=True)
        p.add_argument("--method_name", required=True)
        p.add_argument("--output_path", default="output")
        p.add_argument(
            "--checkpoint", default=None,
            help="PANet weights as msgpack; required unless SKIP_REFINEMENT is set",
        )
        p.add_argument("--fine_mode", default="grid", choices=["grid", "crop"])
        parsers.append(p)
    for p in parsers:
        p.add_argument(
            "--device", default="cuda", choices=["cuda", "cpu"],
            help="'cuda' (default; fails without a card) or 'cpu' (plain PyTorch versions)",
        )

    args = parser.parse_args(argv)
    skip = "SKIP_REFINEMENT" in os.environ
    if not skip and not args.checkpoint:
        parser.error("--checkpoint is required (or set SKIP_REFINEMENT)")
    common = dict(
        skip_refinement=skip, checkpoint=args.checkpoint, fine_mode=args.fine_mode,
        device=args.device,
    )
    if args.command == "eth":
        run_eth(args.dataset_path, args.method_name, args.output_path,
                evaluate=not args.no_eval, **common)
    else:
        run_sfm(args.dataset_path, args.method_name, args.output_path, **common)


if __name__ == "__main__":
    main()
