"""Full SfM reconstruction pipeline, the LFE benchmark path (port of
lfr_tpu/pipelines/reconstruction.py).

Copy the pristine database, import the (optionally refined) features,
verify every pair on the device, run incremental SfM (lfr_tpu_torch.sfm.
mapper), and write the model as TXT + PLY and the matching and
reconstruction statistics as two JSON lines:

    python -m lfr_tpu_torch reconstruct --dataset_path D --method_name M \\
        --matches_file F [--solution_file S] [--output_file O.json] \\
        [--device cpu]

Without ``--solution_file`` the run is ``raw`` (files ``M-raw.db``,
``sparse-M-raw``), with it ``ref``; an existing database is refused.
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
from ..sfm import mapper as mapper_mod
from . import import_features as import_mod


def reconstruction_pipeline(
    dataset_path: str,
    method_name: str,
    matches_file: str,
    solution_file: Optional[str] = None,
    output_file: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Returns {"matching": import stats, "reconstruction": the mapper's
    stats (empty when no model was built)}."""
    dev = resolve_device(device)
    refine = solution_file is not None
    tag = "ref" if refine else "raw"

    paths = types.SimpleNamespace()
    paths.database_path = os.path.join(dataset_path, f"{method_name}-{tag}.db")
    paths.image_path = os.path.join(dataset_path, "images")
    paths.sparse_path = os.path.join(dataset_path, f"sparse-{method_name}-{tag}")

    if os.path.exists(paths.database_path):
        raise FileExistsError(f"Database file already exists: {paths.database_path}")
    shutil.copy(os.path.join(dataset_path, "database.db"), paths.database_path)

    matching_stats = import_mod.import_features(
        method_name,
        paths.database_path,
        paths.image_path,
        matches_file,
        solution_file,
        verbose=verbose,
        device=dev,
    )

    db = db_mod.ColmapDatabase(paths.database_path)
    try:
        model, reconstruction_stats = mapper_mod.reconstruct(
            db, verbose=verbose, device=dev
        )
    finally:
        db.close()
    if model is not None:
        model_mod.write_model(paths.sparse_path, model)
        model_mod.write_ply(paths.sparse_path + ".ply", model.points3D)
    else:
        print("Warning: Could not reconstruct any model")

    stats = dict(matching=matching_stats, reconstruction=reconstruction_stats)
    if output_file:
        with open(output_file, "w") as fh:
            fh.write(json.dumps(matching_stats))
            fh.write("\n")
            fh.write(json.dumps(reconstruction_stats))
    if verbose:
        print(json.dumps(stats))
    return stats


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="incremental SfM pipeline")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--method_name", required=True)
    parser.add_argument("--matches_file", required=True)
    parser.add_argument("--solution_file", default=None)
    parser.add_argument("--output_file", default=None)
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where verification and SfM run (default: the card)",
    )
    args = parser.parse_args(argv)
    reconstruction_pipeline(
        args.dataset_path,
        args.method_name,
        args.matches_file,
        args.solution_file,
        args.output_file,
        device=args.device,
    )


if __name__ == "__main__":
    main()
