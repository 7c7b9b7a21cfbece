"""Image resampling (port of lfr_tpu/ops/image_ops.py): OpenCV's INTER_AREA
area resize as two small banded matrix products, and 2x Gaussian-pyramid
upsampling."""

from __future__ import annotations

import numpy as np
import torch


def area_resize_matrix(in_size: int, out_size: int, scale: float = None) -> np.ndarray:
    """(out_size, in_size) row-stochastic area-averaging matrix.

    Output pixel i averages input pixels over [i*s, (i+1)*s), the INTER_AREA
    definition for any scale.  ``s`` defaults to in/out; pass the original
    downscale factor to window by it instead of the ratio of rounded sizes,
    as OpenCV does.  A window that runs past the image is divided by the part
    of it inside the image, min(s, in_size - i*s), as OpenCV's
    ``computeResizeAreaTab`` does; every other window by ``s``.
    """
    s = in_size / out_size if scale is None else scale
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = i * s
        hi = (i + 1) * s
        cover = min(s, in_size - lo)
        k0 = int(np.floor(lo))
        k1 = min(int(np.ceil(hi)), in_size)
        for k in range(k0, k1):
            overlap = min(hi, k + 1) - max(lo, k)
            if overlap > 0:
                m[i, k] = overlap / cover
    return m


def _apply_band(m: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``m @ x`` over x's first axis for a banded ``m`` (O, I): each output
    sums its few nonzero taps in increasing input order, one rounding per
    product and per sum, so the cost is the taps and not O x I."""
    nz = m != 0
    first = nz.argmax(axis=1)
    count = nz.sum(axis=1)
    rows = np.arange(m.shape[0])
    out = torch.zeros((m.shape[0],) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    for j in range(int(count.max(initial=0))):
        k = np.minimum(first + j, m.shape[1] - 1)
        w = np.where(j < count, m[rows, k], np.float32(0.0)).astype(np.float32)
        w = torch.from_numpy(w).to(x.device).view((-1,) + (1,) * (x.dim() - 1))
        out = out + w * x[torch.from_numpy(k).to(x.device)]
    return out


def area_resize(image: torch.Tensor, out_h: int, out_w: int, scale: float = None) -> torch.Tensor:
    """Area resize of an (H, W, C) image to (out_h, out_w, C), f32 out: the
    products ``R_h @ image @ R_w^T`` of :func:`area_resize_matrix`, taken
    over each band's taps."""
    h, w = image.shape[:2]
    tmp = _apply_band(area_resize_matrix(h, out_h, scale), image.float())
    return _apply_band(area_resize_matrix(w, out_w, scale), tmp.transpose(0, 1)).transpose(0, 1)

#: pyrUp per-axis taps: zero-stuff, then convolve [1 4 6 4 1]/8.
_PYR_EVEN = (1.0 / 8.0, 6.0 / 8.0, 1.0 / 8.0)  # taps hitting even outputs
_PYR_ODD = (4.0 / 8.0, 4.0 / 8.0)             # taps hitting odd outputs


def _pyr_up_axis(x: torch.Tensor) -> torch.Tensor:
    """Upsample axis 0 by 2, reflect-101 borders."""
    n = x.shape[0]
    # Under reflect-101 the zero-stuffed signal continues as x[1] on the left
    # and, because of the trailing stuffed zero, as x[n-1] on the right.
    padded = torch.cat([x[1:2], x, x[n - 1 : n]], dim=0)
    even = _PYR_EVEN[0] * padded[:-2] + _PYR_EVEN[1] * padded[1:-1] + _PYR_EVEN[2] * padded[2:]
    odd = _PYR_ODD[0] * padded[1:-1] + _PYR_ODD[1] * padded[2:]
    return torch.stack([even, odd], dim=1).reshape((2 * n,) + tuple(x.shape[1:]))


def pyr_up(image: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (2H, 2W, C) f32, as cv2.pyrUp."""
    x = _pyr_up_axis(image.float())
    x = _pyr_up_axis(x.transpose(0, 1))
    return x.transpose(0, 1).contiguous()
