"""COLMAP-compatible camera models: projection and undistortion (numpy, on
the host; copy of lfr_tpu/sfm/cameras.py).

Covers the models the reference pipelines encounter (ETH3D calibrations are
PINHOLE; LFE databases use SIMPLE_RADIAL/RADIAL from EXIF bootstraps).
Parameter layouts follow the public COLMAP conventions (see
lfr_tpu_torch.io.colmap_db.CAMERA_MODELS).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..io.colmap_model import Camera


def calibration_matrix(cam: Camera) -> np.ndarray:
    p = cam.params
    if cam.model == "SIMPLE_PINHOLE" or cam.model == "SIMPLE_RADIAL" or cam.model == "RADIAL" or cam.model == "SIMPLE_RADIAL_FISHEYE" or cam.model == "RADIAL_FISHEYE":
        f, cx, cy = p[0], p[1], p[2]
        return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    # PINHOLE / OPENCV / FULL_OPENCV / OPENCV_FISHEYE / THIN_PRISM
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def _distortion_params(cam: Camera) -> np.ndarray:
    p = cam.params
    if cam.model in ("SIMPLE_PINHOLE", "PINHOLE"):
        return np.zeros(0)
    if cam.model == "SIMPLE_RADIAL":
        return np.array([p[3]])
    if cam.model == "RADIAL":
        return np.array([p[3], p[4]])
    if cam.model == "OPENCV":
        return np.array(p[4:8])
    if cam.model == "FULL_OPENCV":
        return np.array(p[4:12])
    if cam.model == "OPENCV_FISHEYE":
        return np.array(p[4:8])
    if cam.model == "FOV":
        return np.array([p[4]])
    if cam.model == "SIMPLE_RADIAL_FISHEYE":
        return np.array([p[3]])
    if cam.model == "RADIAL_FISHEYE":
        return np.array([p[3], p[4]])
    if cam.model == "THIN_PRISM_FISHEYE":
        return np.array(p[4:12])
    raise NotImplementedError(f"camera model {cam.model} not supported yet")


def _fisheye_theta_coords(x, y):
    """Pinhole normalized -> equidistant-fisheye base coords (theta-scaled)
    used by the *_FISHEYE models (public COLMAP convention)."""
    r = np.sqrt(np.maximum(x * x + y * y, 1e-18))
    theta = np.arctan(r)
    s = theta / r
    return x * s, y * s


def distort_normalized(cam: Camera, xy: np.ndarray) -> np.ndarray:
    """Apply distortion to normalized camera coords (N, 2)."""
    d = _distortion_params(cam)
    if d.size == 0:
        return xy
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    if cam.model == "SIMPLE_RADIAL":
        radial = 1.0 + d[0] * r2
        return np.stack([x * radial, y * radial], axis=1)
    if cam.model == "RADIAL":
        radial = 1.0 + d[0] * r2 + d[1] * r2 * r2
        return np.stack([x * radial, y * radial], axis=1)
    if cam.model == "OPENCV":
        k1, k2, p1, p2 = d
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([x * radial + dx, y * radial + dy], axis=1)
    if cam.model == "FULL_OPENCV":
        k1, k2, p1, p2, k3, k4, k5, k6 = d
        r4, r6 = r2 * r2, r2 * r2 * r2
        radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (
            1.0 + k4 * r2 + k5 * r4 + k6 * r6
        )
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([x * radial + dx, y * radial + dy], axis=1)
    if cam.model == "FOV":
        (omega,) = d
        if abs(omega) < 1e-8:
            return xy
        r = np.sqrt(np.maximum(r2, 1e-18))
        factor = np.arctan(2.0 * r * np.tan(omega / 2.0)) / (omega * r)
        return np.stack([x * factor, y * factor], axis=1)
    if cam.model == "OPENCV_FISHEYE":
        k1, k2, k3, k4 = d
        r = np.sqrt(np.maximum(r2, 1e-18))
        th = np.arctan(r)
        th2 = th * th
        thd = th * (1 + k1 * th2 + k2 * th2**2 + k3 * th2**3 + k4 * th2**4)
        s = thd / r
        return np.stack([x * s, y * s], axis=1)
    if cam.model in ("SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        u, v = _fisheye_theta_coords(x, y)
        t2 = u * u + v * v
        if cam.model == "SIMPLE_RADIAL_FISHEYE":
            radial = 1.0 + d[0] * t2
        else:
            radial = 1.0 + d[0] * t2 + d[1] * t2 * t2
        return np.stack([u * radial, v * radial], axis=1)
    if cam.model == "THIN_PRISM_FISHEYE":
        k1, k2, p1, p2, k3, k4, sx1, sy1 = d
        u, v = _fisheye_theta_coords(x, y)
        t2 = u * u + v * v
        radial = k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4
        du = u * radial + 2 * p1 * u * v + p2 * (t2 + 2 * u * u) + sx1 * t2
        dv = v * radial + p1 * (t2 + 2 * v * v) + 2 * p2 * u * v + sy1 * t2
        return np.stack([u + du, v + dv], axis=1)
    raise NotImplementedError


#: Fisheye mappings are far from identity, so the fixed-point inverse
#: needs more sweeps (COLMAP uses a Newton solver; the fixed-point
#: iteration converges for realistic parameter ranges).
_UNDISTORT_ITERS = {
    "OPENCV_FISHEYE": 50,
    "SIMPLE_RADIAL_FISHEYE": 50,
    "RADIAL_FISHEYE": 50,
    "THIN_PRISM_FISHEYE": 50,
    "FOV": 50,
}


def undistort_normalized(cam: Camera, xy: np.ndarray, iterations: int = None) -> np.ndarray:
    """Invert distortion by fixed-point iteration (COLMAP-style)."""
    if _distortion_params(cam).size == 0:
        return xy
    if iterations is None:
        iterations = _UNDISTORT_ITERS.get(cam.model, 10)
    u = xy.copy()
    for _ in range(iterations):
        d = distort_normalized(cam, u) - u  # distortion offset at current estimate
        u = xy - d
    return u


def pixel_to_normalized(cam: Camera, uv: np.ndarray) -> np.ndarray:
    """Pixels -> undistorted normalized coords (N, 2)."""
    K = calibration_matrix(cam)
    xy = (uv - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    return undistort_normalized(cam, xy)


def world_to_pixel(
    cam: Camera, R: np.ndarray, t: np.ndarray, points: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Project world points; returns (uv (N, 2), depth (N,))."""
    c = points @ R.T + t
    depth = c[:, 2]
    xy = c[:, :2] / np.where(np.abs(depth[:, None]) < 1e-12, 1e-12, depth[:, None])
    xy = distort_normalized(cam, xy)
    K = calibration_matrix(cam)
    uv = xy * np.array([K[0, 0], K[1, 1]]) + K[:2, 2]
    return uv, depth
