"""The port's dataset tools (lfr_tpu_torch.pipelines.dataset_tools) against
lfr_tpu's on copies of both fixtures: ``create-db`` (image sizes and EXIF
focal priors from the port's own JPEG reader), ``create-db-eth`` and
``match-list`` / ``image-list`` through the CLIs; the databases' camera and
image rows and the written lists must be equal."""

import os
import shutil
import sqlite3

import pytest

from lfr_tpu.pipelines import dataset_tools as jax_tools
from lfr_tpu_torch.pipelines import dataset_tools

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SCENES = {
    "eth3d": os.path.join("eth3d_mini", "relief_mini"),
    "lfe": os.path.join("lfe_mini", "Fountain_mini"),
}


def _rows(root):
    con = sqlite3.connect(os.path.join(root, "database.db"))
    try:
        return {
            table: con.execute(f"SELECT * FROM {table} ORDER BY 1;").fetchall()
            for table in ("cameras", "images")
        }
    finally:
        con.close()


def _both(tmp_path, scene):
    roots = []
    for pkg in ("jax", "port"):
        dst = tmp_path / pkg / os.path.basename(SCENES[scene])
        shutil.copytree(os.path.join(FIXTURES, SCENES[scene]), dst)
        roots.append(str(dst))
    return roots


@pytest.mark.parametrize("scene,command", [
    ("eth3d", "create-db-eth"), ("eth3d", "create-db"), ("lfe", "create-db"),
])
@pytest.mark.parametrize("mode", ["exhaustive", "sequential"])
def test_databases_and_lists_equal_the_jax_tools(tmp_path, scene, command, mode):
    jax_root, port_root = _both(tmp_path, scene)
    for main, root in ((jax_tools.main, jax_root), (dataset_tools.main, port_root)):
        main([command, "--dataset_path", root])
        main(["match-list", "--dataset_path", root, "--mode", mode, "--num_frames", "2"])
        main(["image-list", "--dataset_path", root])
    want, got = _rows(jax_root), _rows(port_root)
    assert got == want and len(got["images"]) >= 3
    for name in ("match-list.txt", "image-list.txt"):
        with open(os.path.join(jax_root, name)) as fh:
            want_text = fh.read().replace(jax_root, "ROOT")
        with open(os.path.join(port_root, name)) as fh:
            assert fh.read().replace(port_root, "ROOT") == want_text


def test_single_camera_database_equals_the_jax_tools(tmp_path):
    jax_root, port_root = _both(tmp_path, "lfe")
    jax_tools.create_starting_database(jax_root, single_camera=True)
    dataset_tools.create_starting_database(port_root, single_camera=True)
    rows = _rows(port_root)
    assert rows == _rows(jax_root) and len(rows["cameras"]) == 1
