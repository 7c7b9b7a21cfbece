"""COLMAP text-model (cameras/images/points3D .txt) and PLY IO (copy of
lfr_tpu/io/colmap_model.py).

Replaces the reference's shelling out to ``colmap model_converter``
(reference: colmap_utils.py:241-264,313-319) and its ad-hoc images.txt
parsers (reference: colmap_utils.py:20-50,
local-feature-evaluation/compare_reconstructions.py:16-26).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np



@dataclasses.dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class Image:
    image_id: int
    qvec: np.ndarray  # (4,) w, x, y, z — world-to-camera rotation
    tvec: np.ndarray  # (3,) world-to-camera translation
    camera_id: int
    name: str
    xys: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), dtype=np.int64)
    )


@dataclasses.dataclass
class Point3D:
    point3D_id: int
    xyz: np.ndarray   # (3,)
    rgb: np.ndarray   # (3,) uint8
    error: float
    image_ids: np.ndarray     # (K,)
    point2D_idxs: np.ndarray  # (K,)


@dataclasses.dataclass
class Model:
    cameras: Dict[int, Camera] = dataclasses.field(default_factory=dict)
    images: Dict[int, Image] = dataclasses.field(default_factory=dict)
    points3D: Dict[int, Point3D] = dataclasses.field(default_factory=dict)

    def image_by_name(self) -> Dict[str, Image]:
        return {im.name: im for im in self.images.values()}


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------


def read_cameras_txt(path: str) -> Dict[int, Camera]:
    cameras: Dict[int, Camera] = {}
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam = Camera(
                camera_id=int(parts[0]),
                model=parts[1],
                width=int(float(parts[2])),
                height=int(float(parts[3])),
                params=np.array([float(p) for p in parts[4:]]),
            )
            cameras[cam.camera_id] = cam
    return cameras


def read_images_txt(path: str) -> Dict[int, Image]:
    images: Dict[int, Image] = {}
    with open(path, "r") as fh:
        # Keep empty lines: an image with zero points2D still occupies its
        # second line, and dropping it would desynchronize the alternation.
        lines = [ln.strip() for ln in fh if not ln.strip().startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for pose_line, pts_line in zip(lines[::2], lines[1::2] + [""] * (len(lines) % 2)):
        if not pose_line:
            continue
        parts = pose_line.split()
        image = Image(
            image_id=int(parts[0]),
            qvec=np.array([float(p) for p in parts[1:5]]),
            tvec=np.array([float(p) for p in parts[5:8]]),
            camera_id=int(parts[8]),
            name=parts[9],
        )
        if pts_line:
            vals = np.array([float(v) for v in pts_line.split()]).reshape(-1, 3)
            image.xys = vals[:, :2]
            image.point3D_ids = vals[:, 2].astype(np.int64)
        images[image.image_id] = image
    return images


def read_points3D_txt(path: str) -> Dict[int, Point3D]:
    points: Dict[int, Point3D] = {}
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            track = np.array([int(v) for v in parts[8:]]).reshape(-1, 2)
            pt = Point3D(
                point3D_id=int(parts[0]),
                xyz=np.array([float(p) for p in parts[1:4]]),
                rgb=np.array([int(p) for p in parts[4:7]], dtype=np.uint8),
                error=float(parts[7]),
                image_ids=track[:, 0],
                point2D_idxs=track[:, 1],
            )
            points[pt.point3D_id] = pt
    return points


def read_model(path: str) -> Model:
    return Model(
        cameras=read_cameras_txt(os.path.join(path, "cameras.txt")),
        images=read_images_txt(os.path.join(path, "images.txt")),
        points3D=(
            read_points3D_txt(os.path.join(path, "points3D.txt"))
            if os.path.getsize(os.path.join(path, "points3D.txt")) > 0
            else {}
        )
        if os.path.exists(os.path.join(path, "points3D.txt"))
        else {},
    )


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------


def write_cameras_txt(path: str, cameras: Dict[int, Camera]) -> None:
    with open(path, "w") as fh:
        fh.write("# Camera list with one line of data per camera:\n")
        fh.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        fh.write(f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            fh.write(f"{cam.camera_id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_txt(path: str, images: Dict[int, Image]) -> None:
    n_obs = sum(int((im.point3D_ids >= 0).sum()) for im in images.values())
    mean_obs = n_obs / max(len(images), 1)
    with open(path, "w") as fh:
        fh.write("# Image list with two lines of data per image:\n")
        fh.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        fh.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        fh.write(f"# Number of images: {len(images)}, mean observations per image: {mean_obs}\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            fh.write(f"{im.image_id} {q} {t} {im.camera_id} {im.name}\n")
            pts = []
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                pts.append(f"{repr(float(x))} {repr(float(y))} {int(pid)}")
            fh.write(" ".join(pts) + "\n")


def write_points3D_txt(path: str, points3D: Dict[int, Point3D]) -> None:
    mean_track = (
        sum(len(p.image_ids) for p in points3D.values()) / max(len(points3D), 1)
    )
    with open(path, "w") as fh:
        fh.write("# 3D point list with one line of data per point:\n")
        fh.write(
            "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        fh.write(f"# Number of points: {len(points3D)}, mean track length: {mean_track}\n")
        for pt in points3D.values():
            xyz = " ".join(repr(float(v)) for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            track = " ".join(
                f"{int(i)} {int(j)}" for i, j in zip(pt.image_ids, pt.point2D_idxs)
            )
            fh.write(f"{pt.point3D_id} {xyz} {rgb} {repr(float(pt.error))} {track}\n")


def write_model(path: str, model: Model) -> None:
    os.makedirs(path, exist_ok=True)
    write_cameras_txt(os.path.join(path, "cameras.txt"), model.cameras)
    write_images_txt(os.path.join(path, "images.txt"), model.images)
    write_points3D_txt(os.path.join(path, "points3D.txt"), model.points3D)


def write_ply(path: str, points3D: Dict[int, Point3D]) -> None:
    """Binary little-endian PLY of the sparse point cloud (the format the
    ETH3D evaluator consumes; reference: colmap_utils.py:313-319)."""
    pts = list(points3D.values())
    with open(path, "wb") as fh:
        header = (
            "ply\n"
            "format binary_little_endian 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        fh.write(header.encode("ascii"))
        if pts:
            xyz = np.stack([p.xyz for p in pts]).astype("<f4")
            rgb = np.stack([p.rgb for p in pts]).astype(np.uint8)
            rec = np.empty(
                len(pts),
                dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
            )
            rec["xyz"] = xyz
            rec["rgb"] = rgb
            fh.write(rec.tobytes())


def write_ply_mesh(path: str, xyz: np.ndarray, faces: np.ndarray) -> None:
    """Write a binary triangle-mesh PLY (vertices + faces)."""
    n, m = len(xyz), len(faces)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {m}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    ).encode()
    rec = np.zeros(m, dtype=np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
    rec["n"] = 3
    rec["v"] = np.asarray(faces, np.int32)
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(np.asarray(xyz, "<f4").tobytes())
        fh.write(rec.tobytes())


_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
}


def read_ply_mesh(path: str):
    """Read (vertices (N, 3) float64, faces (M, 3) int64 or None) from a
    binary-little-endian or ascii PLY.  Faces beyond triangles are fanned
    into triangles; meshes without a face element return ``faces=None``."""
    with open(path, "rb") as fh:
        data = fh.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii", "replace").splitlines()
    fmt = "binary_little_endian"
    elements = []  # (name, count, [prop spec])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    xyz = None
    faces = None
    if fmt == "ascii":
        rows = [r for r in data[head_end:].decode("ascii").split("\n") if r.strip()]
        cursor = 0
        for name, count, props in elements:
            chunk = rows[cursor : cursor + count]
            cursor += count
            if name == "vertex":
                xyz = np.array([[float(v) for v in r.split()[:3]] for r in chunk])
            elif name == "face" and count:
                tris = []
                for r in chunk:
                    vals = [int(v) for v in r.split()]
                    k = vals[0]
                    for i in range(1, k - 1):
                        tris.append([vals[1], vals[1 + i], vals[2 + i]])
                faces = np.asarray(tris, np.int64) if tris else None
        return xyz, faces

    offset = head_end
    for name, count, props in elements:
        if any(p[0] == "list" for p in props):
            # List-typed element (faces): assume a uniform arity, probe it.
            assert len(props) == 1, "mixed list/scalar face properties unsupported"
            _, cnt_t, idx_t, _ = props[0]
            cnt_dt = np.dtype(_PLY_TYPES[cnt_t])
            idx_dt = np.dtype(_PLY_TYPES[idx_t])
            if count == 0:
                continue
            k = int(np.frombuffer(data, dtype=cnt_dt, count=1, offset=offset)[0])
            rec_dt = np.dtype([("n", cnt_dt), ("v", idx_dt, (k,))])
            rec = np.frombuffer(data, dtype=rec_dt, count=count, offset=offset)
            if not (rec["n"] == k).all():
                # Ragged polygon list: slow path.
                tris, pos = [], offset
                for _ in range(count):
                    n = int(np.frombuffer(data, cnt_dt, 1, pos)[0])
                    pos += cnt_dt.itemsize
                    vals = np.frombuffer(data, idx_dt, n, pos)
                    pos += n * idx_dt.itemsize
                    for i in range(1, n - 1):
                        tris.append([vals[0], vals[i], vals[i + 1]])
                offset = pos
                if name == "face":
                    faces = np.asarray(tris, np.int64)
                continue
            offset += rec_dt.itemsize * count
            if name == "face":
                v = rec["v"].astype(np.int64)
                if k == 3:
                    faces = v
                else:
                    faces = np.concatenate(
                        [np.stack([v[:, 0], v[:, i], v[:, i + 1]], 1) for i in range(1, k - 1)]
                    )
        else:
            dtype = np.dtype([(nm, _PLY_TYPES[t]) for t, nm in props])
            rec = np.frombuffer(data, dtype=dtype, count=count, offset=offset)
            offset += dtype.itemsize * count
            if name == "vertex":
                xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float64)
    return xyz, faces


def read_ply_xyz(path: str) -> np.ndarray:
    """Read vertex positions from a simple binary or ascii PLY."""
    xyz, _ = read_ply_mesh(path)
    return xyz


# ---------------------------------------------------------------------------
# Empty-model generation (fixed-pose triangulation input)
# ---------------------------------------------------------------------------


def generate_empty_model(reference_model_path: str, empty_model_path: str) -> Dict[str, int]:
    """Copy cameras + poses from a ground-truth calibration, with no points
    (reference: colmap_utils.py:20-50)."""
    cameras = read_cameras_txt(os.path.join(reference_model_path, "cameras.txt"))
    images = read_images_txt(os.path.join(reference_model_path, "images.txt"))
    model = Model(cameras=cameras, points3D={})
    for im in images.values():
        model.images[im.image_id] = Image(
            im.image_id, im.qvec, im.tvec, im.camera_id, im.name
        )
    write_model(empty_model_path, model)
    return {im.name: im.image_id for im in images.values()}
