"""Fixed-pose triangulation pipeline, ETH3D layout (port of
lfr_tpu/pipelines/triangulation.py).

Copy the pristine database, import the (optionally refined) features,
verify every pair on the device, triangulate against the ground-truth
calibration, and export the model as TXT + PLY:

    python -m lfr_tpu_torch.pipelines.triangulation --dataset_path D \\
        --method_name M --matches_file F [--solution_file S] \\
        [--reference_model_dir dslr_calibration_undistorted] [--device cpu]

Without ``--solution_file`` the run is ``raw`` (files ``M-raw.db``,
``sparse-M-raw``), with it ``ref``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import types
from typing import Optional

from ..device import resolve_device
from ..io import colmap_db as db_mod
from ..io import colmap_model as model_mod
from ..sfm import triangulate as tri_mod
from ..utils import timing
from . import import_features as import_mod


def triangulation_pipeline(
    dataset_path: str,
    method_name: str,
    matches_file: str,
    solution_file: Optional[str] = None,
    reference_model_dir: str = "dslr_calibration_undistorted",
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Returns {"matching": import stats, "triangulation": analyze_model's
    stats, "timing": spans, "num_tracks": candidate tracks}; the spans are
    ``import_verify`` (with ``keypoints``, ``matches``, ``verify``),
    ``triangulate`` (with ``tracks``, ``pack``, ``device``, ``gate``) and
    ``write_model``."""
    dev = resolve_device(device)
    refine = solution_file is not None
    tag = "ref" if refine else "raw"

    paths = types.SimpleNamespace()
    paths.database_path = os.path.join(dataset_path, f"{method_name}-{tag}.db")
    paths.image_path = os.path.join(dataset_path, "images")
    paths.reference_model_path = os.path.join(dataset_path, reference_model_dir)
    paths.empty_model_path = os.path.join(dataset_path, f"sparse-{method_name}-{tag}-empty")
    paths.model_path = os.path.join(dataset_path, f"sparse-{method_name}-{tag}")
    paths.ply_model_path = os.path.join(dataset_path, f"sparse-{method_name}-{tag}.ply")

    if os.path.exists(paths.database_path):
        raise FileExistsError(
            f"The database file already exists: {paths.database_path}"
        )

    spans = timing.Spans()
    shutil.copyfile(os.path.join(dataset_path, "database.db"), paths.database_path)

    model_mod.generate_empty_model(paths.reference_model_path, paths.empty_model_path)
    with spans.span("import_verify"):
        matching_stats = import_mod.import_features(
            method_name,
            paths.database_path,
            paths.image_path,
            matches_file,
            solution_file,
            verbose=verbose,
            device=dev,
            spans=spans,
        )

    empty_model = model_mod.read_model(paths.empty_model_path)
    db = db_mod.ColmapDatabase(paths.database_path)
    with spans.span("triangulate"):
        result = tri_mod.triangulate_model(
            db, empty_model, verbose=verbose, device=dev, spans=spans
        )
    db.close()

    with spans.span("write_model"):
        model_mod.write_model(paths.model_path, result.model)
        model_mod.write_ply(paths.ply_model_path, result.model.points3D)

    stats = dict(
        matching=matching_stats,
        triangulation=result.stats,
        timing=spans.report(),
        num_tracks=result.num_tracks,
    )
    if verbose:
        print(json.dumps(stats))
    return stats


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="fixed-pose triangulation pipeline")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--method_name", required=True)
    parser.add_argument("--matches_file", required=True)
    parser.add_argument("--solution_file", default=None)
    parser.add_argument("--reference_model_dir", default="dslr_calibration_undistorted")
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where verification and triangulation run (default: the card)",
    )
    args = parser.parse_args(argv)
    triangulation_pipeline(
        args.dataset_path,
        args.method_name,
        args.matches_file,
        args.solution_file,
        args.reference_model_dir,
        device=args.device,
    )


if __name__ == "__main__":
    main()
