"""Host-side image loading and resizing (port of lfr_tpu/io/images.py).

Images are decoded by the port's own PNG and baseline JPEG readers
(:mod:`.png`, :mod:`.jpeg`), chosen by the file's magic bytes: the port
uses neither OpenCV nor PIL.  Grayscale is promoted to 3 channels and an
alpha channel is dropped, as ``cv2.imread`` does; a JPEG decodes bit for
bit as ``cv2.imread`` decodes it, EXIF orientation included.  Other
formats raise.  Downscaling by ``fact`` gives what the
reference's ``cv2.resize(image, None, fx=1/fact, fy=1/fact,
interpolation=cv2.INTER_AREA)`` gives: an output of round(h/fact) x
round(w/fact), each pixel the average over its window of width ``fact``,
divided by the part of the window inside the image, then rounded to uint8
as OpenCV rounds: to nearest, ties to even, except that at an integer
factor the windows wholly inside the image round ties up (OpenCV's
integer-factor route adds half before it shifts).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import downscale_factor
from ..ops.image_ops import area_resize
from .jpeg import decode_jpeg
from .png import SIGNATURE, decode_png


def load_image_rgb(path: str) -> np.ndarray:
    """Load an image as (H, W, 3) uint8 RGB."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(SIGNATURE):
        image = decode_png(data)
    elif data.startswith(b"\xff\xd8"):
        return decode_jpeg(data)
    else:
        raise ValueError(
            f"{path} is neither a PNG nor a JPEG file: lfr_tpu_torch decodes "
            "PNG (8-bit grayscale, RGB or RGBA) and baseline JPEG only"
        )
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=-1)
    return np.ascontiguousarray(image[:, :, :3])


def resize_by_factor(image: np.ndarray, fact: float) -> np.ndarray:
    """INTER_AREA resize of a uint8 image by 1/fact on the host, as OpenCV's
    (module docstring); sizes and window width come from ``inv = 1/fact`` as
    ``cv2.resize`` takes them: round(h * inv), window 1/inv."""
    if fact == 1.0:
        return image
    h, w = image.shape[:2]
    inv = 1.0 / fact
    scale = 1.0 / inv
    out_h, out_w = round(h * inv), round(w * inv)
    out = area_resize(torch.from_numpy(np.ascontiguousarray(image)), out_h, out_w, scale=scale)
    rounded = torch.round(out)
    if scale == round(scale):
        rows = out_h - int(out_h * scale > h)
        cols = out_w - int(out_w * scale > w)
        rounded[:rows, :cols] = torch.floor(out[:rows, :cols] + 0.5)
    return rounded.numpy().astype(image.dtype)


def load_and_downscale(path: str, max_edge: int, max_sum_edges: int) -> Tuple[np.ndarray, float]:
    """Load an RGB image and downscale it to the method's resolution caps.

    Returns (image, fact)."""
    image = load_image_rgb(path)
    h, w = image.shape[:2]
    fact = downscale_factor(h, w, max_edge, max_sum_edges)
    return resize_by_factor(image, fact), fact
