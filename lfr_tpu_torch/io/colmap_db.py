"""COLMAP SQLite database reader/writer (copy of lfr_tpu/io/colmap_db.py).

The framework replaces the external COLMAP CLI round-trips of the reference
(reference: reconstruction-scripts/colmap_utils.py:77-223,
utils/create_starting_database*.py) with a native implementation of the same
on-disk schema, so databases remain interchangeable with COLMAP tooling.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

#: COLMAP pair-id convention (reference: colmap_utils.py:53-57).
MAX_IMAGE_ID = 2147483647

#: COLMAP camera model ids (public COLMAP convention; the reference bootstrap
#: writes model 1 for PINHOLE and 0 otherwise,
#: reference: utils/create_starting_database_eth.py:44-56).
CAMERA_MODELS = {
    "SIMPLE_PINHOLE": 0,
    "PINHOLE": 1,
    "SIMPLE_RADIAL": 2,
    "RADIAL": 3,
    "OPENCV": 4,
    "OPENCV_FISHEYE": 5,
    "FULL_OPENCV": 6,
    "FOV": 7,
    "SIMPLE_RADIAL_FISHEYE": 8,
    "RADIAL_FISHEYE": 9,
    "THIN_PRISM_FISHEYE": 10,
}
CAMERA_MODEL_NAMES = {v: k for k, v in CAMERA_MODELS.items()}
CAMERA_MODEL_NUM_PARAMS = {
    0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4, 9: 5, 10: 12,
}

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def pair_id_from_image_ids(image_id1: int, image_id2: int) -> int:
    """(reference: colmap_utils.py:53-57)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return MAX_IMAGE_ID * image_id1 + image_id2


def image_ids_from_pair_id(pair_id: int) -> Tuple[int, int]:
    return pair_id // MAX_IMAGE_ID, pair_id % MAX_IMAGE_ID


def _blob(array: np.ndarray, dtype) -> bytes:
    return np.ascontiguousarray(array, dtype=dtype).tobytes()


def _unblob(blob, rows: int, cols: int, dtype) -> np.ndarray:
    if blob is None or rows == 0:
        return np.zeros((0, cols), dtype=dtype)
    return np.frombuffer(blob, dtype=dtype).reshape(rows, cols).copy()


class ColmapDatabase:
    """Thin typed wrapper over a COLMAP sqlite database file."""

    def __init__(self, path: str):
        self.path = path
        self.connection = sqlite3.connect(path)

    @classmethod
    def create(cls, path: str) -> "ColmapDatabase":
        db = cls(path)
        db.connection.executescript(_SCHEMA)
        db.connection.commit()
        return db

    def close(self) -> None:
        self.connection.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.connection.commit()
        self.close()

    # -- cameras ----------------------------------------------------------

    def add_camera(
        self,
        model: int,
        width: int,
        height: int,
        params: np.ndarray,
        prior_focal_length: bool = True,
        camera_id: Optional[int] = None,
    ) -> int:
        cur = self.connection.execute(
            "INSERT INTO cameras(camera_id, model, width, height, params, prior_focal_length)"
            " VALUES(?, ?, ?, ?, ?, ?);",
            (camera_id, model, width, height, _blob(params, np.float64), int(prior_focal_length)),
        )
        return cur.lastrowid

    def cameras(self) -> Dict[int, dict]:
        out = {}
        for cid, model, width, height, params, prior in self.connection.execute(
            "SELECT camera_id, model, width, height, params, prior_focal_length FROM cameras;"
        ):
            out[cid] = dict(
                camera_id=cid,
                model=model,
                width=int(width),
                height=int(height),
                params=np.frombuffer(params, dtype=np.float64).copy() if params else np.zeros(0),
                prior_focal_length=bool(prior),
            )
        return out

    # -- images -----------------------------------------------------------

    def add_image(self, name: str, camera_id: int, image_id: Optional[int] = None) -> int:
        cur = self.connection.execute(
            "INSERT INTO images(image_id, name, camera_id) VALUES(?, ?, ?);",
            (image_id, name, camera_id),
        )
        return cur.lastrowid

    def image_ids(self) -> Dict[str, int]:
        """name -> image_id (reference: colmap_utils.py:98-101)."""
        return {
            name: image_id
            for name, image_id in self.connection.execute("SELECT name, image_id FROM images;")
        }

    def image_cameras(self) -> Dict[int, int]:
        return {
            image_id: camera_id
            for image_id, camera_id in self.connection.execute(
                "SELECT image_id, camera_id FROM images;"
            )
        }

    # -- features ---------------------------------------------------------

    def set_keypoints(self, image_id: int, keypoints: np.ndarray) -> None:
        keypoints = np.asarray(keypoints, dtype=np.float32)
        self.connection.execute(
            "INSERT OR REPLACE INTO keypoints(image_id, rows, cols, data) VALUES(?, ?, ?, ?);",
            (image_id, keypoints.shape[0], keypoints.shape[1], _blob(keypoints, np.float32)),
        )

    def keypoints(self, image_id: int) -> np.ndarray:
        row = self.connection.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?;", (image_id,)
        ).fetchone()
        if row is None:
            return np.zeros((0, 4), dtype=np.float32)
        return _unblob(row[2], row[0], row[1], np.float32)

    def set_descriptors(self, image_id: int, descriptors: np.ndarray) -> None:
        descriptors = np.asarray(descriptors, dtype=np.uint8)
        self.connection.execute(
            "INSERT OR REPLACE INTO descriptors(image_id, rows, cols, data) VALUES(?, ?, ?, ?);",
            (image_id, descriptors.shape[0], descriptors.shape[1], _blob(descriptors, np.uint8)),
        )

    def descriptors(self, image_id: int) -> np.ndarray:
        row = self.connection.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id=?;", (image_id,)
        ).fetchone()
        if row is None:
            return np.zeros((0, 128), dtype=np.uint8)
        return _unblob(row[2], row[0], row[1], np.uint8)

    # -- matches ----------------------------------------------------------

    def set_matches(self, image_id1: int, image_id2: int, matches: np.ndarray) -> None:
        """Matches are stored with columns swapped when id1 > id2
        (reference: colmap_utils.py:183-190)."""
        matches = np.asarray(matches, dtype=np.uint32).reshape(-1, 2)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        self.connection.execute(
            "INSERT OR REPLACE INTO matches(pair_id, rows, cols, data) VALUES(?, ?, ?, ?);",
            (
                pair_id_from_image_ids(image_id1, image_id2),
                matches.shape[0],
                2,
                _blob(matches, np.uint32),
            ),
        )

    def matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        row = self.connection.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?;",
            (pair_id_from_image_ids(image_id1, image_id2),),
        ).fetchone()
        if row is None:
            return np.zeros((0, 2), dtype=np.uint32)
        m = _unblob(row[2], row[0], row[1], np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        return m

    def all_matches(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        for pair_id, rows, cols, data in self.connection.execute(
            "SELECT pair_id, rows, cols, data FROM matches;"
        ):
            id1, id2 = image_ids_from_pair_id(pair_id)
            yield id1, id2, _unblob(data, rows, cols, np.uint32)

    # -- two-view geometries ---------------------------------------------

    def set_two_view_geometry(
        self,
        image_id1: int,
        image_id2: int,
        inlier_matches: np.ndarray,
        config: int = 2,
        F: Optional[np.ndarray] = None,
        E: Optional[np.ndarray] = None,
        H: Optional[np.ndarray] = None,
    ) -> None:
        matches = np.asarray(inlier_matches, dtype=np.uint32).reshape(-1, 2)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        eye = np.eye(3, dtype=np.float64)
        self.connection.execute(
            "INSERT OR REPLACE INTO two_view_geometries"
            " (pair_id, rows, cols, data, config, F, E, H, qvec, tvec)"
            " VALUES(?, ?, ?, ?, ?, ?, ?, ?, ?, ?);",
            (
                pair_id_from_image_ids(image_id1, image_id2),
                matches.shape[0],
                2,
                _blob(matches, np.uint32),
                config,
                _blob(F if F is not None else eye, np.float64),
                _blob(E if E is not None else eye, np.float64),
                _blob(H if H is not None else eye, np.float64),
                _blob(np.array([1.0, 0, 0, 0]), np.float64),
                _blob(np.zeros(3), np.float64),
            ),
        )

    def all_two_view_geometries(self) -> Iterator[Tuple[int, int, np.ndarray, int]]:
        for pair_id, rows, cols, data, config in self.connection.execute(
            "SELECT pair_id, rows, cols, data, config FROM two_view_geometries;"
        ):
            id1, id2 = image_ids_from_pair_id(pair_id)
            yield id1, id2, _unblob(data, rows, cols, np.uint32), config

    # -- bulk operations --------------------------------------------------

    def has_inlier_matches_table(self) -> bool:
        """Legacy COLMAP databases use an ``inlier_matches`` table
        (reference: colmap_utils.py:82-90)."""
        row = self.connection.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name='inlier_matches';"
        ).fetchone()
        return row is not None

    def clear_features_and_matches(self) -> None:
        """(reference: colmap_utils.py:89-96)."""
        cur = self.connection
        cur.execute("DELETE FROM keypoints;")
        cur.execute("DELETE FROM descriptors;")
        cur.execute("DELETE FROM matches;")
        if self.has_inlier_matches_table():
            cur.execute("DELETE FROM inlier_matches;")
        else:
            cur.execute("DELETE FROM two_view_geometries;")
        self.connection.commit()

    def matching_stats(self) -> dict:
        """(reference: colmap_utils.py:203-223)."""
        q = self.connection.execute
        num_images = q("SELECT count(*) FROM images;").fetchone()[0]
        num_inlier_pairs = q(
            "SELECT count(*) FROM two_view_geometries WHERE rows > 0;"
        ).fetchone()[0]
        num_inlier_matches = q(
            "SELECT sum(rows) FROM two_view_geometries WHERE rows > 0;"
        ).fetchone()[0]
        return dict(
            num_images=num_images,
            num_inlier_pairs=num_inlier_pairs,
            num_inlier_matches=num_inlier_matches or 0,
        )

    def commit(self) -> None:
        self.connection.commit()
