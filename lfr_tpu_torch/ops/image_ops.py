"""2x Gaussian-pyramid upsampling (port of lfr_tpu/ops/image_ops.py:71-100)."""

from __future__ import annotations

import torch

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
