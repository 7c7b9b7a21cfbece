"""Dataset bootstrap and list-generation tools (port of
lfr_tpu/pipelines/dataset_tools.py).

  * ``create-db``     — database.db with one camera per image from the
    images directory (EXIF focal prior when present);
  * ``create-db-eth`` — database.db from an ETH3D ground-truth calibration;
  * ``match-list``    — exhaustive or sequential pair list;
  * ``image-list``    — absolute image paths for external extractors;
  * ``compare``       — reconstruction comparison on common images.

    python -m lfr_tpu_torch.pipelines.dataset_tools create-db-eth --dataset_path D

Image sizes and the EXIF focal length come from the port's own readers
(:mod:`..io.jpeg`) with the JAX package's semantics, PIL's: the size is
the file's, unrotated by an EXIF orientation (which ``load_image_rgb``
applies), and the focal length is read from IFD0 only (ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..io import colmap_db as db_mod
from ..io import colmap_model as model_mod
from ..io import match_list as ml_mod
from ..io.jpeg import exif_focal_35mm, image_size

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")


def create_starting_database(dataset_path: str, single_camera: bool = False) -> str:
    """Create database.db with one camera per image (EXIF focal prior when
    available, else the COLMAP default 1.25 * max(w, h))."""
    database_path = os.path.join(dataset_path, "database.db")
    image_dir = os.path.join(dataset_path, "images")
    db = db_mod.ColmapDatabase.create(database_path)
    shared_cam = None
    # Recursive: custom datasets may nest images in subdirectories; names
    # stay relative to images/.
    names = []
    for dirpath, dirnames, filenames in os.walk(image_dir):
        dirnames.sort()
        rel = os.path.relpath(dirpath, image_dir)
        for fn in sorted(filenames):
            names.append(fn if rel == "." else os.path.join(rel, fn))
    for name in names:
        if not name.lower().endswith(IMAGE_EXTENSIONS):
            continue
        path = os.path.join(image_dir, name)
        width, height = image_size(path)
        focal = exif_focal_35mm(path, width)
        prior = focal is not None
        if focal is None:
            focal = 1.25 * max(width, height)
        if single_camera and shared_cam is not None:
            cam_id = shared_cam
        else:
            cam_id = db.add_camera(
                db_mod.CAMERA_MODELS["SIMPLE_RADIAL"],
                width,
                height,
                np.array([focal, width / 2.0, height / 2.0, 0.0]),
                prior_focal_length=prior,
            )
            shared_cam = cam_id
        db.add_image(name, cam_id)
    db.commit()
    db.close()
    return database_path


def create_starting_database_eth(dataset_path: str) -> str:
    """Bootstrap from ``dslr_calibration_undistorted``: cameras and images
    with their ground-truth ids."""
    database_path = os.path.join(dataset_path, "database.db")
    ref = os.path.join(dataset_path, "dslr_calibration_undistorted")
    cams = model_mod.read_cameras_txt(os.path.join(ref, "cameras.txt"))
    images = model_mod.read_images_txt(os.path.join(ref, "images.txt"))

    db = db_mod.ColmapDatabase.create(database_path)
    db.connection.execute("DELETE FROM cameras;")
    db.connection.execute("DELETE FROM images;")
    for cam in cams.values():
        model_id = db_mod.CAMERA_MODELS.get(cam.model, 0)
        db.add_camera(
            model_id, cam.width, cam.height, cam.params,
            prior_focal_length=True, camera_id=cam.camera_id,
        )
    for im in images.values():
        db.add_image(im.name, im.camera_id, image_id=im.image_id)
    db.commit()
    db.close()
    return database_path


def images_in_database(dataset_path: str):
    db = db_mod.ColmapDatabase(os.path.join(dataset_path, "database.db"))
    names = [n for n, _ in sorted(db.image_ids().items(), key=lambda kv: kv[1])]
    db.close()
    return names


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="dataset bootstrap / list tools")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("create-db")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--single_camera", action="store_true")

    p = sub.add_parser("create-db-eth")
    p.add_argument("--dataset_path", required=True)

    p = sub.add_parser("match-list")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--mode", choices=["exhaustive", "sequential"], default="exhaustive")
    p.add_argument("--num_frames", type=int, default=3)

    p = sub.add_parser("image-list")
    p.add_argument("--dataset_path", required=True)

    p = sub.add_parser("compare")
    p.add_argument("--raw_reconstruction", required=True)
    p.add_argument("--ref_reconstruction", required=True)

    args = parser.parse_args(argv)

    if args.command == "create-db":
        print(create_starting_database(args.dataset_path, args.single_camera))
    elif args.command == "create-db-eth":
        print(create_starting_database_eth(args.dataset_path))
    elif args.command == "match-list":
        names = images_in_database(args.dataset_path)
        pairs = (
            ml_mod.exhaustive_pairs(names)
            if args.mode == "exhaustive"
            else ml_mod.sequential_pairs(names, args.num_frames)
        )
        out = os.path.join(args.dataset_path, "match-list.txt")
        ml_mod.write_match_list(out, pairs)
        print(f"{out}: {len(pairs)} pairs")
    elif args.command == "image-list":
        names = images_in_database(args.dataset_path)
        out = os.path.join(args.dataset_path, "image-list.txt")
        with open(out, "w") as fh:
            for name in names:
                fh.write(
                    os.path.realpath(os.path.join(args.dataset_path, "images", name)) + "\n"
                )
        print(out)
    elif args.command == "compare":
        from ..eval.compare import compare_reconstructions

        raw = model_mod.read_model(args.raw_reconstruction)
        ref = model_mod.read_model(args.ref_reconstruction)
        raw_stats, ref_stats = compare_reconstructions(raw, ref)
        print("======================")
        print("Raw reconstruction (common images)")
        print("======================")
        print(json.dumps(raw_stats, indent=2))
        print("======================")
        print("Refined reconstruction (common images)")
        print("======================")
        print(json.dumps(ref_stats, indent=2))


if __name__ == "__main__":
    main()
