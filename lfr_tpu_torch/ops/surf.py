"""SURF feature extraction (port of lfr_tpu/ops/surf.py; Bay et al., ECCV 2006).

  * the integral image on the device, in the order XLA's CPU lowering of
    ``jnp.cumsum`` sums (a scan in blocks of 16, see :func:`_cumsum`), so
    it equals the JAX package's bit for bit, and box filters of the scaled
    9x9 OpenCV patterns as strided corner slices of it
    (det H = Dxx*Dyy - (0.9*Dxy)^2);
  * 3x3x3 non-max suppression with quadratic sub-pixel / sub-scale
    interpolation, host numpy as in the JAX package (a copy of
    ``_nms_and_interp``: the same response maps give the same keypoints);
  * dominant orientations from Gaussian-weighted Haar responses in a
    radius-6s disc with a pi/3 sliding window, and the extended 128-D
    descriptor (4x4 subregions of an oriented 20s window, 5x5 Haar samples
    each, sums split by sign), as batched gathers on the integral image on
    the device.

Keypoints follow OpenCV's conventions: (x, y, size, angle in degrees from
+x toward -y); the gray conversion keeps the reference's BGR-weight quirk.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

#: OpenCV defaults (reference: extract_features_surf.py:37-40).
HESSIAN_THRESHOLD = 500.0
N_OCTAVES = 4
N_LAYERS = 4  # filter sizes per octave; layers 1..2 are NMS centres

#: 9x9 base box patterns (x0, y0, x1, y1, weight) from OpenCV surf.cpp.
_DX_BOXES = ((0, 2, 3, 7, 1.0), (3, 2, 6, 7, -2.0), (6, 2, 9, 7, 1.0))
_DY_BOXES = ((2, 0, 7, 3, 1.0), (2, 3, 7, 6, -2.0), (2, 6, 7, 9, 1.0))
_DXY_BOXES = (
    (1, 1, 4, 4, 1.0),
    (5, 1, 8, 4, -1.0),
    (1, 5, 4, 8, -1.0),
    (5, 5, 8, 8, 1.0),
)

#: Block length of the scan that XLA's CPU compiler makes of a cumulative
#: sum (its reduce-window rewriter): a sequential sum inside each block of
#: 16, the block totals scanned the same way, and each block's exclusive
#: prefix added.
_SCAN_BLOCK = 16


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative f32 sum along ``dim`` in the order of ``jnp.cumsum`` on
    the CPU (:data:`_SCAN_BLOCK`); every step is one f32 addition, so the
    result is the same on any device."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    nb = -(-n // _SCAN_BLOCK) if n > _SCAN_BLOCK else 1
    length = _SCAN_BLOCK if n > _SCAN_BLOCK else n
    blocks = torch.zeros((nb * length,) + x.shape[1:], dtype=x.dtype, device=x.device)
    blocks[:n] = x
    blocks = blocks.view((nb, length) + x.shape[1:])
    for k in range(1, length):
        blocks[:, k] += blocks[:, k - 1]
    if nb > 1:
        prefix = _cumsum(blocks[:, -1], 0)
        blocks[1:] += prefix[:-1, None]
    return blocks.reshape((nb * length,) + x.shape[1:])[:n].movedim(0, dim)


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H+1, W+1) with ii[y, x] = sum of img[:y, :x]."""
    ii = _cumsum(_cumsum(img, 0), 1)
    return F.pad(ii, (1, 0, 1, 0))


def _scaled_boxes(pattern, size: int):
    """Scale a 9x9 pattern to ``size``; weights become box averages."""
    ratio = size / 9.0
    out = []
    for x0, y0, x1, y1, w in pattern:
        sx0, sy0 = int(round(x0 * ratio)), int(round(y0 * ratio))
        sx1, sy1 = int(round(x1 * ratio)), int(round(y1 * ratio))
        area = max((sx1 - sx0) * (sy1 - sy0), 1)
        out.append((sx0, sy0, sx1, sy1, w / area))
    return out


def det_hessian_map(ii: torch.Tensor, size: int, stride: int, gh: int, gw: int) -> torch.Tensor:
    """Dense det-of-Hessian response on the (gh, gw) stride grid; grid point
    (gi, gj) is the filter whose window's top-left is pixel (gi*stride,
    gj*stride)."""

    def corner(dy, dx):
        return ii[dy : dy + (gh - 1) * stride + 1 : stride, dx : dx + (gw - 1) * stride + 1 : stride]

    def pattern_sum(pattern):
        acc = None
        for sx0, sy0, sx1, sy1, w in _scaled_boxes(pattern, size):
            box = corner(sy1, sx1) - corner(sy0, sx1) - corner(sy1, sx0) + corner(sy0, sx0)
            term = w * box
            acc = term if acc is None else acc + term
        return acc

    dxx = pattern_sum(_DX_BOXES)
    dyy = pattern_sum(_DY_BOXES)
    dxy = pattern_sum(_DXY_BOXES)
    return dxx * dyy - 0.81 * dxy * dxy


def _octave_sizes(octave: int):
    return [(9 + 6 * layer) << octave for layer in range(N_LAYERS)]


def _response_pyramid(ii: torch.Tensor, h: int, w: int):
    """All (octave, layer) response maps, computed on the device and brought
    to the host one octave at a time as (o, stride, sizes, (L, gh, gw))."""
    # Edge-pad the integral so every layer's slices stay in bounds; grid
    # points whose window exceeds the image are masked below.
    pad = _octave_sizes(N_OCTAVES - 1)[-1] + 8
    ii = F.pad(ii[None, None], (0, pad, 0, pad), mode="replicate")[0, 0]
    pyramid = []
    for o in range(N_OCTAVES):
        stride = 1 << o
        sizes = _octave_sizes(o)
        if min(h, w) < sizes[-1] + 2:
            break
        gh = (h - sizes[0]) // stride + 1
        gw = (w - sizes[0]) // stride + 1
        if gh < 3 or gw < 3:
            break
        maps = torch.stack([det_hessian_map(ii, size, stride, gh, gw) for size in sizes])
        maps = maps.cpu().numpy()
        for m, size in zip(maps, sizes):
            max_g_y = (h - size) // stride + 1
            max_g_x = (w - size) // stride + 1
            if max_g_y < gh:
                m[max_g_y:] = -np.inf
            if max_g_x < gw:
                m[:, max_g_x:] = -np.inf
        pyramid.append((o, stride, sizes, maps))
    return pyramid


def _nms_and_interp(pyramid, threshold: float):
    """3x3x3 NMS + quadratic interpolation.  Returns (x, y, size, score)."""
    out = []
    for o, stride, sizes, R in pyramid:
        L, gh, gw = R.shape
        for layer in range(1, L - 1):
            C = R[layer]
            mask = C > threshold
            # 26-neighbour max comparison.
            neigh_max = np.full_like(C, -np.inf)
            for dl in (-1, 0, 1):
                M = R[layer + dl]
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if dl == 0 and dy == 0 and dx == 0:
                            continue
                        shifted = np.full_like(C, -np.inf)
                        ys = slice(max(dy, 0), gh + min(dy, 0))
                        yd = slice(max(-dy, 0), gh + min(-dy, 0))
                        xs = slice(max(dx, 0), gw + min(dx, 0))
                        xd = slice(max(-dx, 0), gw + min(-dx, 0))
                        shifted[yd, xd] = M[ys, xs]
                        neigh_max = np.maximum(neigh_max, shifted)
            mask &= C > neigh_max
            mask[0, :] = mask[-1, :] = False
            mask[:, 0] = mask[:, -1] = False
            gy, gx = np.nonzero(mask)
            if gy.size == 0:
                continue
            # Quadratic interpolation in (x, y, s).  Masked (-inf) entries
            # near margins produce non-finite intermediates that are
            # discarded by the finite/offset checks below.
            old_err = np.seterr(all="ignore")
            d = np.stack(
                [
                    (C[gy, gx + 1] - C[gy, gx - 1]) / 2,
                    (C[gy + 1, gx] - C[gy - 1, gx]) / 2,
                    (R[layer + 1][gy, gx] - R[layer - 1][gy, gx]) / 2,
                ],
                axis=1,
            )
            dxx = C[gy, gx + 1] + C[gy, gx - 1] - 2 * C[gy, gx]
            dyy = C[gy + 1, gx] + C[gy - 1, gx] - 2 * C[gy, gx]
            dss = R[layer + 1][gy, gx] + R[layer - 1][gy, gx] - 2 * C[gy, gx]
            dxy = (
                C[gy + 1, gx + 1] - C[gy + 1, gx - 1]
                - C[gy - 1, gx + 1] + C[gy - 1, gx - 1]
            ) / 4
            dxs = (
                R[layer + 1][gy, gx + 1] - R[layer + 1][gy, gx - 1]
                - R[layer - 1][gy, gx + 1] + R[layer - 1][gy, gx - 1]
            ) / 4
            dys = (
                R[layer + 1][gy + 1, gx] - R[layer + 1][gy - 1, gx]
                - R[layer - 1][gy + 1, gx] + R[layer - 1][gy - 1, gx]
            ) / 4
            H = np.stack(
                [
                    np.stack([dxx, dxy, dxs], -1),
                    np.stack([dxy, dyy, dys], -1),
                    np.stack([dxs, dys, dss], -1),
                ],
                axis=1,
            )
            with np.errstate(all="ignore"):
                try:
                    offs = -np.linalg.solve(H + 1e-9 * np.eye(3), d[..., None])[..., 0]
                except np.linalg.LinAlgError:
                    offs = np.zeros_like(d)
            np.seterr(**old_err)
            offs = np.where(np.isfinite(offs), offs, 0.0)
            good = (np.abs(offs) <= 1.0).all(axis=1)
            gy, gx, offs = gy[good], gx[good], offs[good]
            if gy.size == 0:
                continue
            size = sizes[layer]
            center_off = (size - 1) / 2.0
            x = (gx + offs[:, 0]) * stride + center_off
            y = (gy + offs[:, 1]) * stride + center_off
            sz = size + offs[:, 2] * (6 << o)
            score = C[gy, gx]
            out.append(np.stack([x, y, sz, score], axis=1))
    if not out:
        return np.zeros((0, 4))
    return np.concatenate(out)


def _haar_xy(ii: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, r: torch.Tensor):
    """Axis-aligned Haar responses of full size 2r at centres (cx, cy), all
    (K, P) with r (K, 1): dx = right half - left half, dy = bottom half -
    top half (image y down).  Boxes snap to integer pixels (round half to
    even, as ``jnp.round``) and corners clamp into the integral image."""
    x0 = torch.round(cx - r).long()
    y0 = torch.round(cy - r).long()
    r2 = (2 * r).long()
    r1 = r.long()
    x1 = x0 + r2
    y1 = y0 + r2
    xm = x0 + r1
    ym = y0 + r1
    h1, w1 = ii.shape

    def at(y, x):
        return ii[y.clamp(0, h1 - 1), x.clamp(0, w1 - 1)]

    def box(ya, xa, yb, xb):
        return at(yb, xb) - at(ya, xb) - at(yb, xa) + at(ya, xa)

    dx = box(y0, xm, y1, x1) - box(y0, x0, y1, xm)
    dy = box(ym, x0, y1, x1) - box(y0, x0, ym, x1)
    return dx, dy


# Orientation sampling disc: integer offsets with i^2 + j^2 <= 36.
_ORI_OFFS = np.array(
    [(i, j) for i in range(-6, 7) for j in range(-6, 7) if i * i + j * j <= 36], np.float32
)
_ORI_GAUSS = np.exp(-(np.sum(_ORI_OFFS**2, axis=1)) / (2 * 2.5**2)).astype(np.float32)

# Descriptor sampling: 20x20 grid (4x4 subregions x 5x5 samples) of unit
# offsets in [-10, 10), (row = y', col = x').
_DESC_GRID = np.stack(
    np.meshgrid(np.arange(20) - 9.5, np.arange(20) - 9.5, indexing="ij"), -1
).astype(np.float32)
_DESC_GAUSS = np.exp(-np.sum(_DESC_GRID**2, axis=-1) / (2 * 3.3**2)).astype(np.float32)


def _orientations(ii: torch.Tensor, xy: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dominant Haar orientation per keypoint (K,), radians from +x toward
    -y: the pi/3 window, at 10-degree steps, with the largest summed
    response."""
    dev = ii.device
    offs = torch.from_numpy(_ORI_OFFS).to(dev)
    gauss = torch.from_numpy(_ORI_GAUSS).to(dev)
    s = scale[:, None]
    px = xy[:, 0:1] + offs[None, :, 1] * s
    py = xy[:, 1:2] + offs[None, :, 0] * s
    r = torch.clamp_min(torch.round(2.0 * s), 1.0)
    dx, dy = _haar_xy(ii, px, py, r)
    dx = dx * gauss
    dy = dy * gauss
    ang = torch.atan2(dy, dx)  # (K, P)
    # jnp.linspace(-pi, pi, 36, endpoint=False)'s formula.
    step = torch.arange(36, dtype=torch.float32, device=dev) / 36.0
    centers = -math.pi * (1 - step) + math.pi * step
    diff = torch.abs(ang[:, None, :] - centers[None, :, None])  # (K, 36, P)
    diff = torch.minimum(diff, 2 * math.pi - diff)
    inside = diff <= (math.pi / 6)
    zero = torch.zeros((), device=dev)
    sx = torch.where(inside, dx[:, None, :], zero).sum(-1)
    sy = torch.where(inside, dy[:, None, :], zero).sum(-1)
    best = torch.argmax(sx * sx + sy * sy, dim=1)[:, None]
    return torch.atan2(-torch.gather(sy, 1, best), torch.gather(sx, 1, best))[:, 0]


def _descriptors(ii: torch.Tensor, xy: torch.Tensor, scale: torch.Tensor, theta: torch.Tensor):
    """Extended 128-D SURF descriptors (K, 128), L2-normalised."""
    dev = ii.device
    grid = torch.from_numpy(_DESC_GRID.reshape(-1, 2)).to(dev)  # (400, 2) (y', x')
    gauss = torch.from_numpy(_DESC_GAUSS.reshape(-1)).to(dev)
    s = scale[:, None]
    ct = torch.cos(theta)[:, None]
    st = torch.sin(theta)[:, None]
    # Rotate the sample offsets into image coordinates (y down).
    gx = grid[None, :, 1] * s
    gy = grid[None, :, 0] * s
    px = xy[:, 0:1] + ct * gx + st * gy
    py = xy[:, 1:2] - st * gx + ct * gy
    r = torch.clamp_min(torch.round(s), 1.0)
    dx, dy = _haar_xy(ii, px, py, r)
    # Rotate the responses into the keypoint frame.
    k = xy.shape[0]
    tdx = ((ct * dx - st * dy) * gauss).reshape(k, 4, 5, 4, 5)
    tdy = ((st * dx + ct * dy) * gauss).reshape(k, 4, 5, 4, 5)
    pos_dy = tdy >= 0
    pos_dx = tdx >= 0
    zero = torch.zeros((), device=dev)

    def sub(vals, mask):
        return torch.where(mask, vals, zero).sum(dim=(2, 4))  # (K, 4, 4)

    feats = torch.stack(
        [
            sub(tdx, ~pos_dy), sub(torch.abs(tdx), ~pos_dy),
            sub(tdx, pos_dy), sub(torch.abs(tdx), pos_dy),
            sub(tdy, ~pos_dx), sub(torch.abs(tdy), ~pos_dx),
            sub(tdy, pos_dx), sub(torch.abs(tdy), pos_dx),
        ],
        dim=-1,
    )  # (K, 4, 4, 8)
    v = feats.reshape(k, -1)
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=1, keepdim=True), 1e-12)


def extract_surf(
    image: np.ndarray,
    max_features: int = 4096,
    threshold: float = HESSIAN_THRESHOLD,
    upright: bool = False,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SURF keypoints + extended descriptors: keypoints (K, 4) [x, y, size,
    angle_deg], scores, descriptors (K, 128) f32."""
    dev = resolve_device(device)
    if image.ndim == 3:
        # The reference feeds an RGB array through COLOR_BGR2GRAY
        # (extract_features_surf.py:50,55), swapping the R/B weights; kept
        # for parity (lfr_tpu/ops/surf.py:369).
        image = image @ np.array([0.114, 0.587, 0.299])
    img = np.ascontiguousarray(image, np.float32)
    if img.max() <= 2.0:
        img = img * 255.0
    h, w = img.shape

    ii = integral_image(torch.from_numpy(img).to(dev))
    kps = _nms_and_interp(_response_pyramid(ii, h, w), threshold)
    if kps.shape[0] == 0:
        return np.zeros((0, 4)), np.zeros(0), np.zeros((0, 128), np.float32)
    if kps.shape[0] > max_features:
        kps = kps[np.argsort(-kps[:, 3])[:max_features]]

    xy = torch.as_tensor(kps[:, :2], dtype=torch.float32, device=dev)
    scale = torch.as_tensor(1.2 * kps[:, 2] / 9.0, dtype=torch.float32, device=dev)
    if upright:
        theta = torch.zeros(kps.shape[0], dtype=torch.float32, device=dev)
    else:
        theta = _orientations(ii, xy, scale)
    desc = _descriptors(ii, xy, scale, theta).cpu().numpy()

    angles_deg = np.degrees(theta.cpu().numpy()) % 360.0
    keypoints = np.stack([kps[:, 0], kps[:, 1], kps[:, 2], angles_deg], axis=1)
    return keypoints, kps[:, 3].copy(), desc.astype(np.float32)
