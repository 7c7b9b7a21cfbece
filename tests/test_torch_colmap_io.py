"""The port's COLMAP database and text-model IO (lfr_tpu_torch.io.colmap_db,
colmap_model) against lfr_tpu's: round trips, and files written by one
package read back by the other, equal (arrays bit for bit, floats exact)."""

import numpy as np
import pytest

from lfr_tpu.io import colmap_db as jax_db
from lfr_tpu.io import colmap_model as jax_model
from lfr_tpu_torch.io import colmap_db, colmap_model

PACKAGES = {"port": (colmap_db, colmap_model), "jax": (jax_db, jax_model)}


def _fill_database(db_mod, path, rng):
    """Cameras, images, keypoints, descriptors, matches and two-view
    geometries, with image_id1 > image_id2 pairs to exercise the swaps."""
    db = db_mod.ColmapDatabase.create(path)
    cam = db.add_camera(1, 640, 480, np.array([500.0, 501.0, 320.0, 240.0]))
    db.add_camera(2, 800, 600, np.array([600.0, 400.0, 300.0, -0.01]), camera_id=7)
    for i in range(3):
        iid = db.add_image(f"im{i}.jpg", cam)
        db.set_keypoints(iid, rng.uniform(0, 600, (10 + i, 4)).astype(np.float32))
        db.set_descriptors(iid, rng.integers(0, 255, (10 + i, 128)).astype(np.uint8))
    m = rng.integers(0, 10, (6, 2)).astype(np.uint32)
    db.set_matches(1, 2, m)
    db.set_matches(3, 1, m[:4])
    F = rng.standard_normal((3, 3))
    db.set_two_view_geometry(2, 3, m[:5], 3, F=F, H=np.eye(3) * 2)
    db.set_two_view_geometry(3, 1, m[:2], 6, F=F)
    db.commit()
    return db


def _database_contents(db):
    out = {"cameras": db.cameras(), "images": db.image_ids(), "image_cameras": db.image_cameras()}
    for iid in sorted(out["images"].values()):
        out[f"kp{iid}"] = db.keypoints(iid)
        out[f"desc{iid}"] = db.descriptors(iid)
    out["m12"], out["m31"], out["m13"] = db.matches(1, 2), db.matches(3, 1), db.matches(1, 3)
    out["all_matches"] = sorted((a, b, m.tobytes()) for a, b, m in db.all_matches())
    out["tvg"] = sorted((a, b, m.tobytes(), c) for a, b, m, c in db.all_two_view_geometries())
    out["raw_tvg"] = db.connection.execute(
        "SELECT * FROM two_view_geometries ORDER BY pair_id;").fetchall()
    out["stats"] = db.matching_stats()
    return out


def _assert_equal(a, b):
    assert type(a) is type(b) or isinstance(a, np.ndarray)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_database_round_trip_and_cross_read(tmp_path, writer):
    path = str(tmp_path / "db.db")
    _fill_database(PACKAGES[writer][0], path, np.random.default_rng(0)).close()
    contents = {}
    for name, (db_mod, _) in PACKAGES.items():
        db = db_mod.ColmapDatabase(path)
        contents[name] = _database_contents(db)
        db.close()
    _assert_equal(contents["port"], contents["jax"])
    # The column swap of id1 > id2 pairs, and pair ids.
    np.testing.assert_array_equal(contents["port"]["m13"], contents["port"]["m31"][:, ::-1])
    assert colmap_db.pair_id_from_image_ids(3, 1) == jax_db.pair_id_from_image_ids(1, 3)
    assert colmap_db.image_ids_from_pair_id(colmap_db.pair_id_from_image_ids(5, 2)) == (2, 5)


def test_database_clear_and_both_writers_write_the_same_bytes(tmp_path):
    dumps = []
    for name, (db_mod, _) in PACKAGES.items():
        db = _fill_database(db_mod, str(tmp_path / f"{name}.db"), np.random.default_rng(1))
        dumps.append(list(db.connection.iterdump()))
        db.clear_features_and_matches()
        assert db.matching_stats()["num_inlier_pairs"] == 0 and db.keypoints(1).shape == (0, 4)
        assert not db.has_inlier_matches_table()
        db.close()
    assert dumps[0] == dumps[1]


def _model(rng):
    m = colmap_model
    model = m.Model()
    model.cameras[1] = m.Camera(1, "PINHOLE", 640, 480, np.array([500.0, 501.0, 320.0, 240.0]))
    model.cameras[2] = m.Camera(2, "SIMPLE_RADIAL", 800, 600, np.array([600.0, 400.0, 300.0, 0.1]))
    for iid in (1, 2, 5):
        R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        R *= np.sign(np.linalg.det(R))
        xys = rng.uniform(0, 600, (4, 2)) if iid != 5 else np.zeros((0, 2))
        pids = np.array([1, -1, 2, -1]) if iid != 5 else np.zeros(0, np.int64)
        model.images[iid] = m.Image(iid, m.rotmat_to_qvec(R), rng.standard_normal(3),
                                    1 + iid % 2, f"im{iid}.jpg", xys, pids)
    for pid in (1, 2):
        model.points3D[pid] = m.Point3D(pid, rng.standard_normal(3), np.array([1, 2, 3], np.uint8),
                                        0.25 * pid, np.array([1, 2]), np.array([0, 2]))
    return model


def _model_files(path):
    return {f: (path / f).read_bytes() for f in ("cameras.txt", "images.txt", "points3D.txt")}


def test_model_text_and_ply_written_alike_and_cross_read(tmp_path):
    model = _model(np.random.default_rng(2))
    colmap_model.write_model(str(tmp_path / "port"), model)
    jax_model.write_model(str(tmp_path / "jax"), model)
    assert _model_files(tmp_path / "port") == _model_files(tmp_path / "jax")
    for reader in (colmap_model, jax_model):
        back = reader.read_model(str(tmp_path / "port"))
        assert list(back.images) == [1, 2, 5] and list(back.points3D) == [1, 2]
        for iid, im in model.images.items():
            np.testing.assert_array_equal(back.images[iid].qvec, im.qvec)
            np.testing.assert_array_equal(back.images[iid].xys, im.xys)
            np.testing.assert_array_equal(back.images[iid].point3D_ids, im.point3D_ids)
        for pid, pt in model.points3D.items():
            np.testing.assert_array_equal(back.points3D[pid].xyz, pt.xyz)
            assert back.points3D[pid].error == pt.error
    colmap_model.write_ply(str(tmp_path / "p.ply"), model.points3D)
    jax_model.write_ply(str(tmp_path / "j.ply"), model.points3D)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(colmap_model.read_ply_xyz(str(tmp_path / "j.ply")),
                                  jax_model.read_ply_xyz(str(tmp_path / "p.ply")))


def test_mesh_ply_and_empty_model(tmp_path):
    rng = np.random.default_rng(3)
    xyz, faces = rng.standard_normal((6, 3)), rng.integers(0, 6, (4, 3))
    colmap_model.write_ply_mesh(str(tmp_path / "m.ply"), xyz, faces)
    for reader in (colmap_model, jax_model):
        v, f = reader.read_ply_mesh(str(tmp_path / "m.ply"))
        np.testing.assert_array_equal(v, xyz.astype(np.float32))
        np.testing.assert_array_equal(f, faces)
    colmap_model.write_model(str(tmp_path / "ref"), _model(rng))
    names = colmap_model.generate_empty_model(str(tmp_path / "ref"), str(tmp_path / "port"))
    assert names == jax_model.generate_empty_model(str(tmp_path / "ref"), str(tmp_path / "jax"))
    assert _model_files(tmp_path / "port") == _model_files(tmp_path / "jax")
    assert colmap_model.read_model(str(tmp_path / "port")).points3D == {}


def test_qvec_rotmat_round_trip_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        R *= np.sign(np.linalg.det(R))
        q = colmap_model.rotmat_to_qvec(R)
        np.testing.assert_array_equal(q, jax_model.rotmat_to_qvec(R))
        np.testing.assert_array_equal(colmap_model.qvec_to_rotmat(q), jax_model.qvec_to_rotmat(q))
        np.testing.assert_allclose(colmap_model.qvec_to_rotmat(q), R, atol=1e-12)
