"""Local real-image corpus for self-supervised patch training (copy of
lfr_tpu/utils/corpus.py).

The training corpus is assembled from real photographs and textures bundled
with installed packages (scikit-learn's sample photos, matplotlib's
grace_hopper, pygame's photo docs, labmaze's game textures), found under the
interpreter's ``purelib`` directory, and read with the port's own decoders
(``io.images.load_image_rgb``: PNG and baseline JPEG).  Where none of those
packages is installed the corpus is empty and ``train(corpus="real")``
raises, as the JAX package does.  Procedural textures (octave noise, 1/f
spectra, Voronoi mosaics) widen it; the dense-text family needs PIL, which
the port does not use, so :func:`_text_texture` returns None and that
family is skipped, as in the JAX package without PIL.
"""

from __future__ import annotations

import glob
import os
import sysconfig
from typing import List, Optional

import numpy as np

#: Real photographs (preferred: natural image statistics).
_PHOTO_CANDIDATES = [
    "sklearn/datasets/images/china.jpg",
    "sklearn/datasets/images/flower.jpg",
    "matplotlib/mpl-data/sample_data/grace_hopper.jpg",
    "pygame/docs/generated/_images/intro_freedom.jpg",
    "pygame/docs/generated/_images/intro_blade.jpg",
    "pygame/docs/generated/_images/camera_average.jpg",
    "pygame/docs/generated/_images/camera_rgb.jpg",
    "pygame/docs/generated/_images/camera_background.jpg",
]

#: Textured surfaces (game assets; structured detail, not sky gradients).
_TEXTURE_GLOBS = [
    "labmaze/assets/style_*/*_d.png",
    "labmaze/assets/style_*/*_m.png",
    # Simulation-suite material scans: wood grain, marble, tile, brushed
    # metal, foil, skin — real-surface statistics at high resolution.
    "gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/textures/*.png",
    "gymnasium_robotics/envs/assets/adroit_hand/resources/textures/*.png",
    # Outdoor ground/sky scans (vegetation-like spectra) + organic skins.
    "dm_control/locomotion/arenas/assets/outdoor_natural/*.png",
    "dm_control/suite/dog_assets/skin_texture.png",
    "dm_control/locomotion/soccer/assets/humanoid/B_01.png",
    "dm_control/locomotion/soccer/assets/humanoid/B_07.png",
]


def _site_packages() -> List[str]:
    return [sysconfig.get_paths()["purelib"]]


def discover_local_images(include_textures: bool = True) -> List[str]:
    """Paths of locally available real images, photos first."""
    roots = _site_packages()
    found: List[str] = []
    for root in roots:
        for rel in _PHOTO_CANDIDATES:
            p = os.path.join(root, rel)
            if os.path.exists(p):
                found.append(p)
        if include_textures:
            for pattern in _TEXTURE_GLOBS:
                found.extend(sorted(glob.glob(os.path.join(root, pattern))))
    return found


def _octave_noise(rng: np.random.Generator, size: int, octaves: int = 6,
                  persistence: float = 0.55) -> np.ndarray:
    """Multi-octave value noise in [0, 1] (fractal surface detail)."""
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        n = max(2, 2 ** (o + 2))
        if n > size:
            break
        coarse = rng.standard_normal((n, n)).astype(np.float32)
        # Bilinear upsample to full resolution.
        yi = np.linspace(0, n - 1, size)
        xi = np.linspace(0, n - 1, size)
        y0 = np.clip(yi.astype(int), 0, n - 2)
        x0 = np.clip(xi.astype(int), 0, n - 2)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        up = (
            coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        out += amp * up
        total += amp
        amp *= persistence
    out /= max(total, 1e-6)
    out -= out.min()
    return out / max(np.ptp(out), 1e-6)


def _spectral_texture(rng: np.random.Generator, size: int, alpha: float) -> np.ndarray:
    """1/f^alpha random-phase texture in [0, 1] (natural-image spectra;
    alpha ~1.8-2.2 matches vegetation/terrain photographs)."""
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.rfftfreq(size)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    spec = (f ** (-alpha / 2.0)) * np.exp(
        2j * np.pi * rng.random((size, fx.shape[1]))
    )
    spec[0, 0] = 0.0
    img = np.fft.irfft2(spec, s=(size, size)).astype(np.float32)
    img -= img.min()
    return img / max(np.ptp(img), 1e-6)


def _voronoi_texture(rng: np.random.Generator, size: int, cells: int) -> np.ndarray:
    """Voronoi cell mosaic in [0, 1] (masonry / shattered-surface edges)."""
    pts = rng.random((cells, 2)) * size
    shades = rng.random(cells).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    d = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
    lab = np.argmin(d, axis=-1)
    return shades[lab]


def _text_texture(rng: np.random.Generator, size: int) -> Optional[np.ndarray]:
    """The dense-text family: None, since rendering glyphs needs PIL
    (lfr_tpu/utils/corpus.py:125 draws them with PIL when it is present)."""
    return None


def procedural_textures(
    rng: np.random.Generator, count: int = 24, size: int = 512
) -> List[np.ndarray]:
    """Procedurally generated training textures (float32 RGB, [0, 255]).

    Families cycle through fractal octave noise, 1/f^alpha spectra
    (vegetation/terrain-like), Voronoi mosaics, and dense text — surface
    statistics the bundled-photo corpus is thin on.  Each sample gets a
    random 3-channel colorization so conv1 sees varied chroma.
    """
    out: List[np.ndarray] = []
    kinds = ["octave", "spectral", "voronoi", "text"]
    k = 0
    while len(out) < count:
        kind = kinds[k % len(kinds)]
        k += 1
        if kind == "octave":
            g = _octave_noise(rng, size, octaves=int(rng.integers(4, 8)))
        elif kind == "spectral":
            g = _spectral_texture(rng, size, alpha=float(rng.uniform(1.4, 2.4)))
        elif kind == "voronoi":
            g = _voronoi_texture(rng, size, cells=int(rng.integers(40, 400)))
            # Soften cell interiors with a little octave detail so patches
            # inside a cell are not featureless.
            g = 0.75 * g + 0.25 * _octave_noise(rng, size, octaves=5)
        else:
            g = _text_texture(rng, size)
            if g is None:
                continue
        lo = rng.random(3) * 80.0
        hi = 170.0 + rng.random(3) * 85.0
        rgb = lo[None, None, :] + g[..., None] * (hi - lo)[None, None, :]
        out.append(rgb.astype(np.float32))
    return out


def load_corpus(
    max_images: Optional[int] = None,
    min_size: int = 128,
    include_textures: bool = True,
    exclude: Optional[List[str]] = None,
) -> List[np.ndarray]:
    """Load the corpus as float32 RGB arrays.

    ``exclude``: substrings of paths to hold out (e.g. for validation).
    A file the port's decoders cannot read is skipped, as ``cv2.imread``'s
    None is in the JAX package.
    """
    from ..io.images import load_image_rgb

    images = []
    for path in discover_local_images(include_textures):
        if exclude and any(e in path for e in exclude):
            continue
        try:
            img = load_image_rgb(path)
        except (OSError, ValueError):
            continue
        if min(img.shape[:2]) < min_size:
            continue
        images.append(img.astype(np.float32))
        if max_images and len(images) >= max_images:
            break
    return images
