"""Batched bilinear patch and crop sampling (port of lfr_tpu/ops/patches.py).

Every extractor reads, per center, one integer-aligned window of a
reflect-padded (H, W, C) image, or of image ``img_idx[n]`` of an
(S, H, W, C) stack (the stacked mode of the cross-pair stream), and interpolates it with two (samples x
window) hat-weight matrices, one per axis: weight max(0, 1 - |rel - col|)
for a sample at window coordinate ``rel``.  The window's origin is clamped
into the image (lfr_tpu/ops/patches.py:134-136); a tap that then falls
outside the window gets no weight, exactly as in the JAX code.  Centers are
in the padded image's coordinates and outputs are f32.

:func:`sample_bilinear` is the plain gather form of the JAX package's
``sample_bilinear`` (reflection at the edge pixels' centers, four taps),
which SIFT's gradient sampling and :func:`extract_patches` use.
:func:`reflect_pad_image` and :func:`extract_patches` complete the module
(lfr_tpu/ops/patches.py:257,272); no pipeline calls them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import PATCH_SIZE

#: Reflection margin added around images; must exceed the largest patch
#: half-extent used anywhere (fine pass: 16.5*2 + 16 grid + 1 ~ 50 px on the
#: 2x image).
REFLECT_MARGIN = 96


def reflect_coord(x: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect a continuous pixel coordinate into [0, size-1], the period
    2*(size-1) of align_corners=True reflection (lfr_tpu/ops/patches.py:21).
    ``torch.remainder`` takes the divisor's sign, as ``jnp.mod``."""
    span = float(max(size - 1, 1))
    x = torch.remainder(x, 2.0 * span)
    return torch.where(x > span, 2.0 * span - x, x)


def sample_bilinear(
    image: torch.Tensor, ij: torch.Tensor, size: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """Bilinearly sample ``image`` (H, W, C) at continuous (row, col)
    positions ``ij`` (..., 2) with reflection at the border
    (lfr_tpu/ops/patches.py:33).  ``size``: the valid (h, w) extent of a
    padded image, which reflection and clamping then use.  Returns (..., C)."""
    h, w = (image.shape[0], image.shape[1]) if size is None else (int(size[0]), int(size[1]))
    i = reflect_coord(ij[..., 0], h)
    j = reflect_coord(ij[..., 1], w)
    i0f = torch.floor(i)
    j0f = torch.floor(j)
    di = (i - i0f)[..., None]
    dj = (j - j0f)[..., None]
    i0 = i0f.long()
    j0 = j0f.long()
    i1 = (i0 + 1).clamp(0, h - 1)
    j1 = (j0 + 1).clamp(0, w - 1)
    i0 = i0.clamp(0, h - 1)
    j0 = j0.clamp(0, w - 1)
    return (
        image[i0, j0] * (1 - di) * (1 - dj)
        + image[i0, j1] * (1 - di) * dj
        + image[i1, j0] * di * (1 - dj)
        + image[i1, j1] * di * dj
    )


def _hat_weights(
    first: torch.Tensor, pos: torch.Tensor, axis_size: int, window: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """first: (N,) position of the first sample; pos: (N, S) all sample
    positions along one axis.  Returns the clamped window origin (N,) int64
    and the (N, S, window) interpolation weights."""
    base = torch.floor(first).to(torch.int64).clamp(0, axis_size - window)
    rel = pos - base.to(pos.dtype)[:, None]
    cols = torch.arange(window, dtype=torch.float32, device=pos.device)
    return base, (1.0 - (rel[..., None] - cols).abs()).clamp_min(0.0)


def _sample(image: torch.Tensor, bi, wi, bj, wj, window: int, img_idx=None) -> torch.Tensor:
    """(N, R, window) x crop (N, window, window, C) x (N, Q, window) -> (N, R, Q, C).

    ``image`` is one (H, W, C) image, or an (S, H, W, C) stack from which
    ``img_idx`` (N,) picks each center's image."""
    ar = torch.arange(window, device=image.device)
    rows = (bi[:, None] + ar)[:, :, None]
    cols = (bj[:, None] + ar)[:, None, :]
    if img_idx is None:
        crop = image[rows, cols].float()  # (N, window, window, C)
    else:
        crop = image[img_idx.long()[:, None, None], rows, cols].float()
    tmp = torch.einsum("nrw,nwvc->nrvc", wi, crop)
    return torch.einsum("nqv,nrvc->nrqc", wj, tmp)


def _linspace_offsets(patch_size: int, device) -> torch.Tensor:
    # Sample spacing ps/(ps-1) px, spanning +-ps/2 (lfr_tpu/ops/patches.py:126).
    return torch.linspace(
        -patch_size / 2.0, patch_size / 2.0, patch_size, dtype=torch.float32, device=device
    )


def extract_patches_separable(
    image_padded: torch.Tensor, ij: torch.Tensor, patch_size: int = PATCH_SIZE,
    window: int = None, img_idx: torch.Tensor = None,
) -> torch.Tensor:
    """(H, W, C) image, (N, 2) centers -> (N, ps, ps, C) patches on the
    ps/(ps-1)-spaced grid."""
    if window is None:
        window = patch_size + 4
    ij = ij.float()
    offs = _linspace_offsets(patch_size, ij.device)
    h, w = image_padded.shape[-3], image_padded.shape[-2]
    pos_i = ij[:, 0:1] + offs
    pos_j = ij[:, 1:2] + offs
    bi, wi = _hat_weights(pos_i[:, 0], pos_i, h, window)
    bj, wj = _hat_weights(pos_j[:, 0], pos_j, w, window)
    return _sample(image_padded, bi, wi, bj, wj, window, img_idx)


def extract_patch_grid_separable(
    image_padded: torch.Tensor, ij: torch.Tensor, grid_step: int,
    patch_size: int = PATCH_SIZE, img_idx: torch.Tensor = None,
) -> torch.Tensor:
    """All 9 patches of the 3x3 (+-grid_step px) offset grid per center, from
    one shared window.  Returns (N, 9, ps, ps, C), offset-major in
    meshgrid-ij order."""
    window = patch_size + 4 + 2 * grid_step
    ij = ij.float()
    offs = _linspace_offsets(patch_size, ij.device)
    shifts = torch.tensor(
        [-float(grid_step), 0.0, float(grid_step)], dtype=torch.float32, device=ij.device
    )
    h, w = image_padded.shape[-3], image_padded.shape[-2]

    def axis(center, size):
        first = center + shifts[0] + offs[0]
        pos = ((center[:, None, None] + shifts[:, None]) + offs).reshape(center.shape[0], -1)
        return _hat_weights(first, pos, size, window)

    bi, wi = axis(ij[:, 0], h)
    bj, wj = axis(ij[:, 1], w)
    out = _sample(image_padded, bi, wi, bj, wj, window, img_idx)  # (N, 3ps, 3ps, C)
    n, c = out.shape[0], out.shape[-1]
    out = out.reshape(n, 3, patch_size, 3, patch_size, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, 9, patch_size, patch_size, c)


def extract_crops_unit(
    image_padded: torch.Tensor, ij: torch.Tensor, crop_size: int,
    img_idx: torch.Tensor = None,
) -> torch.Tensor:
    """Unit-lattice crops: ``crop_size`` samples at 1 px spacing centered on
    each (i, j).  Returns (N, cs, cs, C)."""
    window = crop_size + 2
    ij = ij.float()
    offs = torch.arange(crop_size, dtype=torch.float32, device=ij.device) - (crop_size - 1) / 2.0
    h, w = image_padded.shape[-3], image_padded.shape[-2]
    pos_i = ij[:, 0:1] + offs
    pos_j = ij[:, 1:2] + offs
    bi, wi = _hat_weights(pos_i[:, 0], pos_i, h, window)
    bj, wj = _hat_weights(pos_j[:, 0], pos_j, w, window)
    return _sample(image_padded, bi, wi, bj, wj, window, img_idx)


def patch_offsets(patch_size: int = PATCH_SIZE, device=None) -> torch.Tensor:
    """(ps, ps, 2) f32 grid of (di, dj) offsets spanning +-ps/2 px at spacing
    ps/(ps-1) (lfr_tpu/ops/patches.py:75)."""
    r = _linspace_offsets(patch_size, device)
    return torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1)


def effective_margin(image: np.ndarray, margin: int = REFLECT_MARGIN) -> int:
    """The margin :func:`reflect_pad_image` pads: capped below the image size."""
    return int(min(margin, image.shape[0] - 1, image.shape[1] - 1))


def reflect_pad_image(image: np.ndarray, margin: int = REFLECT_MARGIN) -> np.ndarray:
    """Host-side reflect-101 padding of an (H, W, C) array by
    :func:`effective_margin` (lfr_tpu/ops/patches.py:257)."""
    m = effective_margin(image, margin)
    return np.pad(image, ((m, m), (m, m), (0, 0)), mode="reflect")


def extract_patches(
    image: torch.Tensor, ij: torch.Tensor, patch_size: int = PATCH_SIZE,
    size: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Patches centered at continuous (i, j) positions by four-tap bilinear
    gathers with reflection (lfr_tpu/ops/patches.py:272).  image (H, W, C),
    ij (N, 2), ``size`` the valid extent of a padded image.  Returns
    (N, ps, ps, C)."""
    offs = patch_offsets(patch_size, image.device)
    coords = ij[:, None, None, :].float() + offs[None]
    return sample_bilinear(image, coords, size=size)
