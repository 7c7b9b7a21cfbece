"""SIFT feature extraction (port of lfr_tpu/ops/sift.py).

The detector runs as fixed-shape torch programs on the device: a separable
Gaussian pyramid, the DoG 3x3x3 extremum test computed densely, the
closed-form 3x3 subpixel solve at every pixel, a top-k per octave, and the
36-bin orientation histograms and 128-D descriptors as batched bilinear
gathers of dense gradient images and one-hot products.  The host prepares
the image (gray, reflect bucket pad, uint8 upload) and unpacks the per-octave
(K, 7) f32 meta block and (K, 128) uint8 descriptor block, as in the JAX
package, so both packages cut the same features from the same blocks.

Every f32 product (the blur's convolutions, the one-hot histograms and the
descriptor product) runs without TF32 whatever the caller's settings
(``matchers.strict_f32``): TF32 would move the pyramid by about 1e-3 and
change keypoints.  ``torch.roll`` wraps around as ``jnp.roll`` does, and
tensor ``%`` is Python's modulo, as ``jnp``'s.

Output follows the framework's npz contract: keypoints (K, 4) = (x, y,
scale, orientation) in input-image pixels, scores, and L2-normalised 128-D
descriptors.  No kernel of ours: the JAX package's extractors are XLA-fused
jnp, not Pallas.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..device import resolve_device
from .matchers import strict_f32
from .patches import sample_bilinear

#: SIFT constants (COLMAP/Lowe conventions; lfr_tpu/ops/sift.py:29-37).
NUM_SCALES = 3              # scales per octave
SIGMA0 = 1.6                # base blur of octave 0, level 0
INIT_SIGMA = 0.5            # assumed blur of the input image
PEAK_THRESHOLD = 0.02 / 3.0  # COLMAP SiftExtraction.peak_threshold default
EDGE_THRESHOLD = 10.0
ORI_BINS = 36
DESC_BINS = 8
DESC_WIDTH = 4              # 4x4 spatial histograms
DESC_SAMPLES = 16           # 16x16 gradient samples

#: Images pad (reflect) to multiples of this before extraction.
SIFT_IMAGE_BUCKET = 128

#: Profiler ranges of the device stages in :func:`_sift_pyramid`: the
#: Gaussian pyramid with the DoG, the candidates, and the orientations with
#: descriptors.
STAGES = ("sift/pyramid", "sift/candidates", "sift/features")


def _gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _blur(image: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur of (H, W) with reflect padding (the edge
    sample excluded, as ``jnp.pad(..., "reflect")``); the kernel is
    symmetric, so correlation equals ``jnp.convolve``."""
    k = torch.from_numpy(kernel).to(image.device)
    r = (kernel.shape[0] - 1) // 2
    x = F.pad(image[None, None], (0, 0, r, r), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.pad(x, (r, r, 0, 0), mode="reflect")
    return F.conv2d(x, k.view(1, 1, 1, -1))[0, 0]


def _downsample2(image: torch.Tensor) -> torch.Tensor:
    return image[::2, ::2]


def _gaussian_octaves(
    img: torch.Tensor, n_octaves: int, base_sigma: float, increments: Sequence[float]
) -> Iterator[torch.Tensor]:
    """Yield each octave's Gaussian stack (1 + len(increments), H, W): the
    first level blurs the octave's image by ``base_sigma`` (octave 0) or is
    the previous octave's level NUM_SCALES taken at every second pixel."""
    if not img.is_floating_point():
        img = img.float() / 255.0
    octave_img = _blur(img, _gaussian_kernel(base_sigma))
    for _ in range(n_octaves):
        gaussians = [octave_img]
        for s_inc in increments:
            gaussians.append(_blur(gaussians[-1], _gaussian_kernel(s_inc)))
        yield torch.stack(gaussians)
        octave_img = _downsample2(gaussians[NUM_SCALES])


def _neighbour_extrema(d: torch.Tensor):
    """Per level, the max and min over the 3x3 spatial neighbourhood
    without the centre (``same``) and with it (``up``), each neighbour by
    ``torch.roll``: the masks of lfr_tpu/ops/sift.py:74-85 without its
    (9, S, H, W) stack."""
    same_max = same_min = None
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            r = torch.roll(d, (di, dj), (1, 2))
            same_max = r if same_max is None else torch.maximum(same_max, r)
            same_min = r if same_min is None else torch.minimum(same_min, r)
    return same_max, same_min, torch.maximum(same_max, d), torch.minimum(same_min, d)


def _octave_candidates(d: torch.Tensor, top_k: int, peak_threshold: float = PEAK_THRESHOLD):
    """Dense extremum detection + subpixel refinement on one octave.

    d: (S+2, H, W) response stack (DoG for SIFT, det-of-Hessian for DoH).
    Returns (scores (K,), pos (K, 3) = (level, i, j) refined, valid (K,)).
    """
    s, h, w = d.shape
    same, same_min, up_max, up_min = _neighbour_extrema(d)

    center = d[1 : s - 1]
    is_max = (center > same[1 : s - 1]) & (center > up_max[: s - 2]) & (center > up_max[2:])
    is_min = (center < same_min[1 : s - 1]) & (center < up_min[: s - 2]) & (center < up_min[2:])
    extremum = (is_max | is_min) & (torch.abs(center) > 0.8 * peak_threshold)

    border = 8
    ii = torch.arange(h, device=d.device)
    jj = torch.arange(w, device=d.device)
    inb = ((ii >= border) & (ii < h - border))[:, None] & ((jj >= border) & (jj < w - border))[None, :]
    extremum = extremum & inb[None]

    scores, deltas = [], []
    for lv in range(1, s - 1):
        dc, dn, dp = d[lv], d[lv + 1], d[lv - 1]
        dxx = torch.roll(dc, -1, 1) + torch.roll(dc, 1, 1) - 2 * dc
        dyy = torch.roll(dc, -1, 0) + torch.roll(dc, 1, 0) - 2 * dc
        dxy = (
            torch.roll(dc, (-1, -1), (0, 1))
            - torch.roll(dc, (-1, 1), (0, 1))
            - torch.roll(dc, (1, -1), (0, 1))
            + torch.roll(dc, (1, 1), (0, 1))
        ) / 4.0
        gx = (torch.roll(dc, -1, 1) - torch.roll(dc, 1, 1)) / 2.0
        gy = (torch.roll(dc, -1, 0) - torch.roll(dc, 1, 0)) / 2.0
        ds_ = (dn - dp) / 2.0
        dss = dn + dp - 2 * dc
        dxs = (torch.roll(dn, -1, 1) - torch.roll(dn, 1, 1) - torch.roll(dp, -1, 1)
               + torch.roll(dp, 1, 1)) / 4.0
        dys = (torch.roll(dn, -1, 0) - torch.roll(dn, 1, 0) - torch.roll(dp, -1, 0)
               + torch.roll(dp, 1, 0)) / 4.0

        # Edge response on the 2x2 spatial Hessian.
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        r = EDGE_THRESHOLD
        edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

        # Subpixel offset: the closed-form symmetric 3x3 cofactor solve of
        # H3 delta = -g, regularised to stay finite on flats.
        dxx_r = dxx + 1e-8
        dyy_r = dyy + 1e-8
        dss_r = dss + 1e-8
        c00 = dyy_r * dss_r - dys * dys
        c01 = dxs * dys - dxy * dss_r
        c02 = dxy * dys - dyy_r * dxs
        c11 = dxx_r * dss_r - dxs * dxs
        c12 = dxy * dxs - dxx_r * dys
        c22 = dxx_r * dyy_r - dxy * dxy
        det3 = dxx_r * c00 + dxy * c01 + dxs * c02
        inv_det = torch.where(torch.abs(det3) > 1e-20, 1.0 / det3, torch.zeros_like(det3))
        delta = torch.stack(
            [
                -(c00 * gx + c01 * gy + c02 * ds_) * inv_det,
                -(c01 * gx + c11 * gy + c12 * ds_) * inv_det,
                -(c02 * gx + c12 * gy + c22 * ds_) * inv_det,
            ],
            -1,
        )  # (H, W, 3) x, y, s
        ok_delta = torch.all(torch.abs(delta) < 1.5, dim=-1)
        value = dc + 0.5 * (gx * delta[..., 0] + gy * delta[..., 1] + ds_ * delta[..., 2])
        strong = torch.abs(value) > peak_threshold
        mask = extremum[lv - 1] & edge_ok & ok_delta & strong
        scores.append(torch.where(mask, torch.abs(value), torch.zeros_like(value)))
        deltas.append(delta)

    score_map = torch.stack(scores)  # (S, H, W)
    delta_map = torch.stack(deltas)  # (S, H, W, 3)
    # jax.lax.approx_max_k on the CPU returns top_k's indices in its order;
    # zero scores fill the unused slots and are masked on the host.
    top, idx = torch.topk(score_map.reshape(-1), top_k)
    lv = idx // (h * w)
    ij = idx % (h * w)
    i = ij // w
    j = ij % w
    delta = delta_map.reshape(-1, 3)[idx]
    pos = torch.stack(
        [
            lv.float() + 1.0 + delta[:, 2],  # refined level (1-based)
            i.float() + delta[:, 1],         # row
            j.float() + delta[:, 0],         # col
        ],
        dim=1,
    )
    return top, pos, top > 0


def _gradient_stack(G: torch.Tensor) -> torch.Tensor:
    """(L, H, W) gaussians -> (H, W, S*2) gradients of levels 1..NUM_SCALES,
    channels [level, (gx, gy)]: gx the column derivative, gy the y-up
    (negated row) derivative (lfr_tpu/ops/sift.py:204)."""
    levels = G[1 : NUM_SCALES + 1]
    gx = (torch.roll(levels, -1, 2) - torch.roll(levels, 1, 2)) / 2.0
    gy = -(torch.roll(levels, -1, 1) - torch.roll(levels, 1, 1)) / 2.0
    grad = torch.stack([gx, gy], -1)  # (S, H, W, 2)
    s, h, w, _ = grad.shape
    return grad.permute(1, 2, 0, 3).reshape(h, w, s * 2)


def _sample_gradients(grad_stack, coords, level):
    """One bilinear gather of all levels' gradients at coords (K, P, 2), then
    each keypoint's level (K,) int64 selected: the value JAX's one-hot
    einsum gives (x * 1 + 0 * y is x).  Returns (gxv, gyv), each (K, P)."""
    g = sample_bilinear(grad_stack, coords)  # (K, P, S*2)
    k, p, _ = g.shape
    g = g.reshape(k, p, -1, 2)
    sel = g[torch.arange(k, device=g.device), :, level]  # (K, P, 2)
    return sel[..., 0], sel[..., 1]


def _orientation_histogram(grad_stack, kp_ij, sigma, level):
    """36-bin orientation histogram around each keypoint (K, 36): gradients
    in a 16x16 window of radius 4.5 sigma, Gaussian weighted, split between
    two bins, then circularly smoothed twice (lfr_tpu/ops/sift.py:233)."""
    dev = grad_stack.device
    lin = torch.linspace(-1.0, 1.0, 16, device=dev)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    window = torch.stack([gy, gx], -1).reshape(-1, 2)  # (256, 2) unit offsets
    radius = 3.0 * 1.5 * sigma  # Lowe: 1.5 sigma Gaussian, 3x radius
    coords = kp_ij[:, None, :] + window[None] * radius[:, None, None]

    gxv, gyv = _sample_gradients(grad_stack, coords, level)
    mag = torch.sqrt(gxv**2 + gyv**2)
    ang = torch.atan2(gyv, gxv)

    gauss_w = torch.exp(-(window[:, 0] ** 2 + window[:, 1] ** 2) / (2 * (2.0 / 3) ** 2))
    wmag = mag * gauss_w[None]

    bins = (ang / (2 * math.pi) * ORI_BINS) % ORI_BINS
    b0 = torch.floor(bins).long() % ORI_BINS
    frac = bins - torch.floor(bins)
    onehot0 = F.one_hot(b0, ORI_BINS).float()
    onehot1 = F.one_hot((b0 + 1) % ORI_BINS, ORI_BINS).float()
    hist = torch.einsum("ks,ksb->kb", wmag * (1 - frac), onehot0) + torch.einsum(
        "ks,ksb->kb", wmag * frac, onehot1
    )
    for _ in range(2):
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    return hist


def _descriptors(grad_stack, kp_ij, sigma, theta, level):
    """128-D SIFT descriptors (K, 128): a rotated 16x16 gradient grid over
    +-2 histogram widths (3 sigma each) into 4x4x8 bins with bilinear
    spatial weights as one product, normalised, clipped at 0.2 and
    renormalised (lfr_tpu/ops/sift.py:272)."""
    dev = grad_stack.device
    n = DESC_SAMPLES
    lin = (torch.arange(n, device=dev) + 0.5) / n * DESC_WIDTH - DESC_WIDTH / 2
    u, v = torch.meshgrid(lin, lin, indexing="ij")
    grid = torch.stack([u, v], -1).reshape(-1, 2)  # (256, 2), histogram-width units

    hist_width = 3.0 * sigma
    cos_t = torch.cos(theta)[:, None]
    sin_t = torch.sin(theta)[:, None]
    # Rotate the (row, col) offsets by theta.
    off_r = cos_t * grid[None, :, 0] - sin_t * grid[None, :, 1]
    off_c = sin_t * grid[None, :, 0] + cos_t * grid[None, :, 1]
    offsets = torch.stack([off_r, off_c], -1) * hist_width[:, None, None]
    coords = kp_ij[:, None, :] + offsets

    gxv, gyv = _sample_gradients(grad_stack, coords, level)
    mag = torch.sqrt(gxv**2 + gyv**2)
    ang = torch.atan2(gyv, gxv) - theta[:, None]

    gauss_w = torch.exp(-(grid[:, 0] ** 2 + grid[:, 1] ** 2) / (2 * (DESC_WIDTH / 2) ** 2))
    wmag = mag * gauss_w[None]

    # Spatial bilinear weights into the 4x4 cells: (256, 16).
    cell_centers = torch.arange(DESC_WIDTH, device=dev) - (DESC_WIDTH - 1) / 2.0
    du = (1.0 - torch.abs(grid[:, 0:1] - cell_centers[None])).clamp_min(0.0)
    dv = (1.0 - torch.abs(grid[:, 1:2] - cell_centers[None])).clamp_min(0.0)
    spatial = (du[:, :, None] * dv[:, None, :]).reshape(-1, DESC_WIDTH * DESC_WIDTH)

    bins = (ang / (2 * math.pi) * DESC_BINS) % DESC_BINS
    b0 = torch.floor(bins).long() % DESC_BINS
    frac = bins - torch.floor(bins)
    ori = F.one_hot(b0, DESC_BINS).float() * (1 - frac)[..., None] + F.one_hot(
        (b0 + 1) % DESC_BINS, DESC_BINS
    ).float() * frac[..., None]  # (K, 256, 8)

    weighted = ori * wmag[..., None]
    desc = torch.einsum("sc,ksb->kcb", spatial, weighted).reshape(-1, 128)

    desc = desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=1, keepdim=True), 1e-12)
    desc = torch.clamp_max(desc, 0.2)
    return desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=1, keepdim=True), 1e-12)


def _keypoint_features(G, scores, pos, valid, sigma0: float):
    """Orientation and descriptors of one octave's candidates, packed into a
    (K, 7) f32 meta block (score, level, i, j, valid, sigma, theta) and a
    (K, 128) uint8 descriptor block at Lowe's x512 convention."""
    lv = pos[:, 0]
    ij = pos[:, 1:3]
    sigma = sigma0 * (2.0 ** ((lv - 1.0) / NUM_SCALES))  # octave pixels
    level = torch.clamp(torch.round(lv - 1.0).long() + 1, 1, NUM_SCALES) - 1
    grad_stack = _gradient_stack(G)

    hist = _orientation_histogram(grad_stack, ij, sigma, level)
    # Parabolic peak interpolation over the circular histogram.
    peak = torch.argmax(hist, dim=1)

    def take1(idx):
        return torch.gather(hist, 1, idx[:, None])[:, 0]

    left = take1((peak - 1) % ORI_BINS)
    right = take1((peak + 1) % ORI_BINS)
    center = take1(peak)
    denom = left - 2.0 * center + right
    offset = torch.where(
        torch.abs(denom) > 1e-12, 0.5 * (left - right) / denom, torch.zeros_like(denom)
    )
    theta = (peak.float() + offset + 0.5) / ORI_BINS * 2.0 * math.pi

    desc = _descriptors(grad_stack, ij, sigma, theta, level)
    meta = torch.cat(
        [scores[:, None], pos, valid[:, None].float(), sigma[:, None], theta[:, None]], dim=1
    )
    desc_u8 = torch.clamp(torch.round(desc * 512.0), 0.0, 255.0).to(torch.uint8)
    return meta, desc_u8


def _device_octave_features(G, R, top_k: int, peak_threshold: float, sigma0: float):
    """One octave's candidates, orientations and descriptors on the device
    (G: (L, H, W) gaussians, R: (S+2, H, W) response stack); see
    :func:`_keypoint_features`."""
    scores, pos, valid = _octave_candidates(R, top_k, peak_threshold)
    return _keypoint_features(G, scores, pos, valid, sigma0)


def _sift_increments() -> Tuple[float, List[float]]:
    """(base blur of octave 0, the blur increments between levels)."""
    k = 2.0 ** (1.0 / NUM_SCALES)
    sigmas = [SIGMA0 * (k**i) for i in range(NUM_SCALES + 3)]
    inc = [math.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-8)) for i in range(1, len(sigmas))]
    return math.sqrt(max(SIGMA0**2 - INIT_SIGMA**2, 0.01)), inc


def _sift_pyramid(img: torch.Tensor, n_octaves: int, max_per_octave: int):
    """Whole-image SIFT on the device: (sum K, 7) meta and (sum K, 128)
    uint8 descriptor blocks, octave after octave.  The three stages run
    inside the profiler ranges of :data:`STAGES`, so a trace splits the
    device time between them."""
    base, inc = _sift_increments()
    octaves = _gaussian_octaves(img, n_octaves, base, inc)
    out = []
    for octave in range(n_octaves):
        with record_function(STAGES[0]):
            G = next(octaves)
            D = G[1:] - G[:-1]
        # Detection counts drop ~4x per octave; the budget shrinks with them.
        top_k = max(256, max_per_octave >> octave)
        with record_function(STAGES[1]):
            scores, pos, valid = _octave_candidates(D, top_k, PEAK_THRESHOLD)
        with record_function(STAGES[2]):
            out.append(_keypoint_features(G, scores, pos, valid, SIGMA0))
    return torch.cat([m for m, _ in out]), torch.cat([d for _, d in out])


def prepare_image(image: np.ndarray, min_dim: float, device):
    """Gray-convert and bucket-pad (reflect) an input image on the host and
    upload it: 0-255 images as uint8 (the pyramid converts on the device),
    [0, 1] floats as f32.  Returns (img (H, W) tensor, true_h, true_w,
    n_octaves)."""
    if image.ndim == 3:
        image = image @ np.array([0.299, 0.587, 0.114])
    true_h, true_w = image.shape
    pad_h = -(-true_h // SIFT_IMAGE_BUCKET) * SIFT_IMAGE_BUCKET - true_h
    pad_w = -(-true_w // SIFT_IMAGE_BUCKET) * SIFT_IMAGE_BUCKET - true_w
    if pad_h or pad_w:
        image = np.pad(
            image, ((0, min(pad_h, true_h - 1)), (0, min(pad_w, true_w - 1))), mode="reflect"
        )
    if image.dtype == np.uint8:
        host = image
    elif image.max() > 2:
        host = np.clip(np.round(image), 0, 255).astype(np.uint8)
    else:
        host = np.asarray(image, np.float32)
    img = torch.from_numpy(np.ascontiguousarray(host)).to(device)
    h, w = img.shape
    n_octaves = max(1, int(np.log2(min(h, w) / min_dim)))
    return img, true_h, true_w, n_octaves


def octave_sizes(n_octaves: int, max_per_octave: int) -> List[int]:
    """Per-octave candidate budgets (as the pyramid functions use them)."""
    return [max(256, max_per_octave >> o) for o in range(n_octaves)]


def collect_octave_features(meta, desc_u8, sizes, true_h, true_w, max_features):
    """Host tail shared by the detectors (numpy, as lfr_tpu/ops/sift.py:453):
    unpack the meta and descriptor blocks, mask invalid slots, map back to
    input-image pixels, drop reflect-band mirrors, keep the top-K, and
    dequantize + renormalise the descriptors."""
    all_kp, all_scores, all_desc = [], [], []
    offset = 0
    for octave, k in enumerate(sizes):
        block = meta[offset : offset + k]
        dblock = desc_u8[offset : offset + k]
        offset += k
        scores = block[:, 0]
        pos = block[:, 1:4]
        valid = block[:, 4] > 0
        sigma = block[:, 5]
        theta = block[:, 6]
        take = np.nonzero(valid)[0]
        if not take.size:
            continue
        ij = pos[take, 1:3]
        mult = 2.0**octave
        xy = ij[:, ::-1] * mult  # (col, row) -> (x, y)
        kp = np.stack([xy[:, 0], xy[:, 1], sigma[take] * mult, theta[take]], axis=1)
        all_kp.append(kp)
        all_scores.append(scores[take])
        all_desc.append(dblock[take])

    if not all_kp:
        return np.zeros((0, 4)), np.zeros(0), np.zeros((0, 128), np.float32)

    kp = np.concatenate(all_kp)
    scores = np.concatenate(all_scores)
    desc = np.concatenate(all_desc)
    inside = (kp[:, 0] < true_w - 0.5) & (kp[:, 1] < true_h - 0.5)
    kp, scores, desc = kp[inside], scores[inside], desc[inside]
    if kp.shape[0] > max_features:
        order = np.argsort(-scores)[:max_features]
        kp, scores, desc = kp[order], scores[order], desc[order]
    desc = desc.astype(np.float32) / 512.0
    desc /= np.maximum(np.linalg.norm(desc, axis=1, keepdims=True), 1e-12)
    return kp, scores, desc


def dispatch_sift(
    image: np.ndarray, max_features: int = 4096, max_per_octave: int = 2048, device="cuda"
):
    """Upload one image and enqueue its extraction; returns a handle for
    :func:`collect_sift`.  On the card the launches return before the device
    finishes, so the caller can prepare the next image meanwhile."""
    dev = resolve_device(device)
    img, true_h, true_w, n_octaves = prepare_image(image, 16.0, dev)
    with strict_f32():
        meta, desc = _sift_pyramid(img, n_octaves, max_per_octave)
    return meta, desc, octave_sizes(n_octaves, max_per_octave), true_h, true_w, max_features


def collect_sift(handle) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Wait for a :func:`dispatch_sift` handle and return its features."""
    meta, desc, sizes, true_h, true_w, max_features = handle
    return collect_octave_features(
        meta.cpu().numpy(), desc.cpu().numpy(), sizes, true_h, true_w, max_features
    )


def extract_sift(
    image: np.ndarray, max_features: int = 4096, max_per_octave: int = 2048, device="cuda"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SIFT features of an (H, W) or (H, W, 3) image: keypoints (K, 4) [x,
    y, scale, orientation], scores (K,), descriptors (K, 128) L2-normalised
    f32, in input-image pixels."""
    return collect_sift(dispatch_sift(image, max_features, max_per_octave, device))
