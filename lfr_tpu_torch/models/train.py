"""Self-supervised training of the patch-alignment flow CNN (port of
lfr_tpu/models/train.py).

Reference / target patch pairs are sampled from images with a known
sub-pixel displacement between their centres plus photometric jitter
(numpy, on the host, the same draws from the same ``np.random.Generator``
as the JAX package), and the unfolded PANet regresses that displacement in
16-px units, with a symmetry term tying the two directions.  Adam under
optax's ``warmup_cosine_decay_schedule(0, lr, min(200, n // 10 + 1), n,
0.02 lr)``.  The host loop keeps the JAX package's structure: 16 sampled
batches per chunk, one upload per chunk, the losses read once a chunk, the
validation (``corpus="real"``) at chunk boundaries, and the best snapshot
kept.

In train mode the correlation is the plain differentiable torch version
and the convolutions are cuDNN's, as the JAX package computes both outside
any Pallas kernel; :func:`evaluate_px_error` is an eval-mode forward, which
launches the ``lfr_corr_asym`` kernel on the card.  The weights start from
:func:`lfr_tpu_torch.models.panet.init_variables` (torch generators, flax's
distributions), not from JAX's draws.

    python -m lfr_tpu_torch.models.train --output ckpt.msgpack [--device cpu]
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import DISPLACEMENT_UNIT_PX, PATCH_SIZE
from ..device import resolve_device
from ..ops.patches import patch_offsets
from ..utils import synthetic
from . import panet

#: Photos held out of the "real" corpus by default: every image the JAX
#: package's accuracy A/B renders evaluation scenes from (train.py:339).
DEFAULT_HOLDOUT = ("china", "flower", "grace_hopper")

#: Batches sampled, uploaded and stepped per host round (JAX's scan chunk).
CHUNK = 16

#: Patches per eval-mode forward in :func:`evaluate_px_error`.
EVAL_CHUNK = 128


# ---------------------------------------------------------------------------
# Schedule, loss and step
# ---------------------------------------------------------------------------


def warmup_steps(num_steps: int) -> int:
    return min(200, num_steps // 10 + 1)


def lr_factor(count: int, num_steps: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, lr, w, n, 0.02 lr)`` at
    ``count``, divided by lr: linear from 0 over the w warm-up steps, then a
    cosine from 1 to 0.02 over the remaining n - w."""
    w = warmup_steps(num_steps)
    decay = num_steps - w
    if decay <= 0:
        raise ValueError(f"the cosine decay needs num_steps > {w}, got {num_steps}")
    if count < w:
        return min(max(count, 0), w) / w
    c = min(count - w, decay)
    return 0.98 * 0.5 * (1.0 + math.cos(math.pi * c / decay)) + 0.02


def make_optimizer(
    model: torch.nn.Module, learning_rate: float, num_steps: Optional[int] = None
) -> Tuple[torch.optim.Optimizer, Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """Adam (optax's b1, b2, eps) and, with ``num_steps``, the warm-up cosine
    schedule as a LambdaLR stepped after each optimizer step, so that step
    k (from 0) runs at lr * lr_factor(k): optax evaluates the schedule at
    the count before its increment, so the first step has learning rate 0."""
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if num_steps is None:
        return optimizer, None
    factor = functools.partial(lambda n, k: lr_factor(k, n), num_steps)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def loss_fn(model: panet.PANet, ref: torch.Tensor, tgt: torch.Tensor, delta: torch.Tensor):
    """The JAX package's loss (train.py:70-96): both directions of one
    train-mode forward_sym against -delta and +delta, plus 0.1 times the
    symmetry term."""
    d12, d21 = model.forward_sym(panet.normalize_patches(ref), panet.normalize_patches(tgt),
                                 train=True)
    main = ((d12 + delta) ** 2).sum(-1).mean() + ((d21 - delta) ** 2).sum(-1).mean()
    sym = ((d12 + d21) ** 2).sum(-1).mean()
    return main + 0.1 * sym


def train_step(model, optimizer, ref, tgt, delta, scheduler=None) -> torch.Tensor:
    """One Adam step on a batch; updates the parameters and the BatchNorm
    running statistics in place and returns the loss (not synchronised)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, ref, tgt, delta)
    loss.backward()
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return loss.detach()


# ---------------------------------------------------------------------------
# Data generation (numpy copies: the same generator gives the same batches)
# ---------------------------------------------------------------------------


def _offsets() -> np.ndarray:
    return patch_offsets(PATCH_SIZE).numpy()


def _np_sample_bilinear(img: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Bilinear sampling of img (H, W, C) at (i, j) coords (..., 2).  The
    samplers keep a margin beyond any warp and displacement, so clamping
    equals the reflecting sampler there (train.py:120)."""
    h, w = img.shape[:2]
    i = np.clip(coords[..., 0], 0.0, h - 1.0)
    j = np.clip(coords[..., 1], 0.0, w - 1.0)
    i0 = np.minimum(np.floor(i).astype(np.int32), h - 2)
    j0 = np.minimum(np.floor(j).astype(np.int32), w - 2)
    di = (i - i0)[..., None]
    dj = (j - j0)[..., None]
    return (
        img[i0, j0] * (1 - di) * (1 - dj)
        + img[i0, j0 + 1] * (1 - di) * dj
        + img[i0 + 1, j0] * di * (1 - dj)
        + img[i0 + 1, j0 + 1] * di * dj
    )


def sample_batch(
    rng: np.random.Generator,
    images: list,
    batch_size: int,
    max_disp_px: float = 8.0,
    jitter: float = 0.08,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ref, tgt, delta_units) patch pairs: the target is the same content
    re-sampled at centre + delta px with brightness / contrast jitter
    (train.py:145)."""
    margin = float(np.ceil(PATCH_SIZE / 2.0 + max_disp_px)) + 1.0
    usable = [im for im in images if min(im.shape[:2]) > 2 * margin]
    if not usable:
        raise ValueError(
            f"no training image exceeds the minimum size of {int(2 * margin) + 1}px per "
            f"side required for patch_size={PATCH_SIZE}, max_disp_px={max_disp_px}"
        )
    per_image = max(1, -(-batch_size // len(usable)))
    offs = _offsets()
    refs, tgts, deltas = [], [], []
    remaining = batch_size
    for img in usable:
        n = min(per_image, remaining)
        if n <= 0:
            break
        h, w = img.shape[:2]
        centers = np.stack(
            [rng.uniform(margin, h - margin, n), rng.uniform(margin, w - margin, n)], axis=1
        )
        delta_px = rng.uniform(-max_disp_px, max_disp_px, (n, 2))
        ref = _np_sample_bilinear(img, centers[:, None, None, :] + offs[None])
        tgt = _np_sample_bilinear(img, (centers + delta_px)[:, None, None, :] + offs[None])
        scale = 1.0 + rng.uniform(-jitter, jitter, (n, 1, 1, 1))
        shift = rng.uniform(-jitter, jitter, (n, 1, 1, 1)) * 255.0
        refs.append(ref)
        tgts.append(np.clip(tgt * scale + shift, 0, 255))
        deltas.append(delta_px / DISPLACEMENT_UNIT_PX)
        remaining -= n
    return _stack(refs, tgts, deltas, batch_size)


def _stack(refs, tgts, deltas, batch_size):
    ref = np.concatenate(refs)[:batch_size]
    tgt = np.concatenate(tgts)[:batch_size]
    delta = np.concatenate(deltas)[:batch_size]
    return ref.astype(np.float32), tgt.astype(np.float32), delta.astype(np.float32)


def sample_batch_warped(
    rng: np.random.Generator,
    images: list,
    batch_size: int,
    max_disp_px: float = 8.0,
    jitter: float = 0.15,
    max_rot: float = 0.25,
    scale_range: Tuple[float, float] = (0.85, 1.18),
    noise: float = 4.0,
    occlusion_prob: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Warped-patch pairs: the target re-sampled at centre + delta through a
    random similarity warp, with gain, bias, gamma and sensor noise, and
    with ``occlusion_prob`` a half-plane from another image (train.py:207).
    The label stays -delta."""
    offs = _offsets()
    half = PATCH_SIZE / 2.0
    reach = half * scale_range[1] * (np.cos(max_rot) + abs(np.sin(max_rot)))
    margin = float(np.ceil(reach + max_disp_px)) + 2.0
    refs, tgts, deltas = [], [], []
    img_ids = rng.integers(0, len(images), batch_size)
    for i in np.unique(img_ids):
        n = int((img_ids == i).sum())
        if n <= 0:
            continue
        img = images[i]
        h, w = img.shape[:2]
        if h <= 2 * margin or w <= 2 * margin:
            img_ids[img_ids == i] = rng.integers(0, len(images))
            continue
        centers = np.stack(
            [rng.uniform(margin, h - margin, n), rng.uniform(margin, w - margin, n)], axis=1
        )
        delta_px = rng.uniform(-max_disp_px, max_disp_px, (n, 2))
        theta = rng.uniform(-max_rot, max_rot, n)
        scale = rng.uniform(scale_range[0], scale_range[1], n)
        ca, sa = np.cos(theta) * scale, np.sin(theta) * scale
        warp = np.stack([np.stack([ca, -sa], -1), np.stack([sa, ca], -1)], axis=1)
        ref = _np_sample_bilinear(img, centers[:, None, None, :] + offs[None])
        tgt = _np_sample_bilinear(
            img, (centers + delta_px)[:, None, None, :] + np.einsum("nab,ijb->nija", warp, offs)
        )
        gain = 1.0 + rng.uniform(-jitter, jitter, (n, 1, 1, 1))
        bias = rng.uniform(-jitter, jitter, (n, 1, 1, 1)) * 255.0
        gamma = np.exp(rng.uniform(-0.15, 0.15, (n, 1, 1, 1)))
        tgt = np.clip(tgt * gain + bias, 0, 255)
        tgt = 255.0 * (tgt / 255.0) ** gamma
        tgt = np.clip(tgt + rng.normal(0, noise, tgt.shape), 0, 255)
        if occlusion_prob > 0.0:
            tgt = _occlude_half_plane(rng, tgt, images, occlusion_prob)
        refs.append(ref)
        tgts.append(tgt)
        deltas.append(delta_px / DISPLACEMENT_UNIT_PX)
    return _stack(refs, tgts, deltas, batch_size)


def _occlude_half_plane(
    rng: np.random.Generator, tgt: np.ndarray, images: list, prob: float,
    min_offset: float = 4.0,
) -> np.ndarray:
    """Overwrite a random half-plane of some targets, at least
    ``min_offset`` px from the centre, with a crop of another image
    (train.py:306)."""
    n, ps = tgt.shape[0], tgt.shape[1]
    hit = rng.random(n) < prob
    if not hit.any():
        return tgt
    ii, jj = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
    ii = ii - (ps - 1) / 2.0
    jj = jj - (ps - 1) / 2.0
    out = tgt.copy()
    for k in np.flatnonzero(hit):
        theta = rng.uniform(0, 2 * np.pi)
        offset = rng.uniform(min_offset, ps / 2.0)
        mask = ii * np.cos(theta) + jj * np.sin(theta) > offset
        src = images[rng.integers(0, len(images))]
        h, w = src.shape[:2]
        if h <= ps or w <= ps:
            continue
        r0 = rng.integers(0, h - ps)
        c0 = rng.integers(0, w - ps)
        out[k][mask] = src[r0 : r0 + ps, c0 : c0 + ps][mask]
    return out


def synthetic_images(rng: np.random.Generator, count: int = 8, h: int = 256, w: int = 256):
    return [synthetic.textured_image(rng, h, w).astype(np.float32) for _ in range(count)]


# ---------------------------------------------------------------------------
# Corpus, evaluation and the training loop
# ---------------------------------------------------------------------------


def _load_dir(image_dir: str) -> list:
    from ..io.images import load_image_rgb

    images = []
    for name in sorted(os.listdir(image_dir))[:64]:
        try:
            images.append(load_image_rgb(os.path.join(image_dir, name)).astype(np.float32))
        except (OSError, ValueError):
            continue
    return images


def _real_corpus(rng, holdout):
    """(training images, validation images or None) of the "real" corpus:
    the held-out photos validate, procedural textures widen the training
    set (train.py:407-440)."""
    from ..io.images import load_image_rgb
    from ..utils.corpus import discover_local_images, load_corpus, procedural_textures

    images = load_corpus(exclude=list(holdout))
    val_paths = [p for p in discover_local_images(include_textures=False)
                 if any(h in p for h in holdout)]
    val_images = []
    for p in val_paths:
        try:
            val_images.append(load_image_rgb(p).astype(np.float32))
        except (OSError, ValueError):
            continue
    if not images:
        raise RuntimeError("no local real images found; use corpus='synthetic'")
    n_real = len(images)
    images = images + procedural_textures(rng, count=max(16, n_real // 2))
    print(
        f"[train] real corpus: {n_real} bundled + {len(images) - n_real} procedural images, "
        f"held out for validation: {[os.path.basename(p) for p in val_paths]}",
        flush=True,
    )
    return images, val_images or None


def load_model(variables, compute_dtype=torch.bfloat16, device="cuda") -> panet.PANet:
    """An unfolded PANet on ``device`` holding ``variables`` (JAX layout)."""
    model = panet.PANet(compute_dtype, folded=False)
    model.load_state_dict(panet.from_jax_variables(variables))
    return model.to(resolve_device(device))


@torch.no_grad()
def _px_error(model: panet.PANet, batch) -> float:
    ref, tgt, delta = batch
    dev = next(model.parameters()).device
    d12 = []
    for s in range(0, ref.shape[0], EVAL_CHUNK):
        r = torch.from_numpy(ref[s : s + EVAL_CHUNK]).to(dev)
        t = torch.from_numpy(tgt[s : s + EVAL_CHUNK]).to(dev)
        out = model(panet.normalize_patches(r), panet.normalize_patches(t), train=False)
        d12.append(out.float().cpu().numpy())
    d12 = np.concatenate(d12)
    return float(np.linalg.norm((d12 + delta) * DISPLACEMENT_UNIT_PX, axis=-1).mean())


def evaluate_px_error(variables, batch, compute_dtype=torch.bfloat16, device="cuda") -> float:
    """Mean alignment error in px of the eval-mode d12 against the known
    displacement, in chunks of 128 pairs (train.py:522)."""
    return _px_error(load_model(variables, compute_dtype, device).eval(), batch)


def train(
    num_steps: int = 1000,
    batch_size: int = 64,
    learning_rate: float = 1e-3,
    image_dir: Optional[str] = None,
    corpus: str = "synthetic",
    warp: bool = False,
    seed: int = 0,
    log_every: int = 50,
    eval_every: int = 500,
    compute_dtype: torch.dtype = torch.bfloat16,
    checkpoint_path: Optional[str] = None,
    holdout: Tuple[str, ...] = DEFAULT_HOLDOUT,
    occlusion_prob: float = 0.0,
    device="cuda",
    timing: Optional[dict] = None,
) -> dict:
    """Train PANet; returns the variables {params, batch_stats} in the JAX
    layout: the snapshot of best validation error where there is a
    validation set (``corpus="real"``), else the last.

    ``corpus``: "synthetic" (random textures) or "real" (locally bundled
    photos and textures, see utils.corpus), unless ``image_dir`` is given.
    ``warp``: warped targets with noise (:func:`sample_batch_warped`);
    ``occlusion_prob`` applies there.  ``timing``: if a dict, it receives
    the host seconds of sampling and upload (``sample``), the seconds of
    the steps through the read of their losses (``steps``) and every
    step's loss (``losses``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = load_model(panet.init_variables(seed), compute_dtype, dev).train()
    optimizer, scheduler = make_optimizer(model, learning_rate, num_steps)

    val_images = None
    if image_dir is not None:
        images = _load_dir(image_dir)
    elif corpus == "real":
        images, val_images = _real_corpus(rng, holdout)
    else:
        images = synthetic_images(rng)

    sampler: Callable = sample_batch
    if warp:
        sampler = functools.partial(sample_batch_warped, occlusion_prob=occlusion_prob)
    val_batch = val_batch_occ = None
    if val_images:
        val_rng = np.random.default_rng(12345)
        val_batch = sample_batch_warped(val_rng, val_images, 256)
        val_batch_occ = sample_batch_warped(val_rng, val_images, 256, occlusion_prob=0.5)

    if timing is not None:
        timing.update(sample=0.0, steps=0.0, losses=[])
    best_val = float("inf")
    result = None
    step = 0
    while step < num_steps:
        k = min(CHUNK, num_steps - step)
        t0 = time.perf_counter()
        batches = [sampler(rng, images, batch_size) for _ in range(k)]
        ref_all, tgt_all, delta_all = (
            torch.from_numpy(np.stack([b[i] for b in batches])).to(dev) for i in range(3)
        )
        t1 = time.perf_counter()
        losses = torch.stack([
            train_step(model, optimizer, ref_all[s], tgt_all[s], delta_all[s], scheduler)
            for s in range(k)
        ]).float().cpu().numpy()
        t2 = time.perf_counter()
        if timing is not None:
            timing["sample"] += t1 - t0
            timing["steps"] += t2 - t1
            timing["losses"].extend(float(v) for v in losses)
        if log_every:
            for s in range(step + 1, step + k + 1):
                if s == 1 or s % log_every == 0:
                    print(f"[train] step {s} loss {float(losses[s - step - 1]):.5f}", flush=True)
        step += k
        # Validation at chunk boundaries, as the JAX package's scan chunks.
        if val_batch is not None and eval_every and (step - k) // eval_every != step // eval_every:
            model.eval()
            err, err_occ = _px_error(model, val_batch), _px_error(model, val_batch_occ)
            model.train()
            print(f"[train] step {step} val error {err:.3f} px (occlusion {err_occ:.3f} px)",
                  flush=True)
            if err < best_val:
                best_val = err
                result = panet.to_jax_variables(model)
                if checkpoint_path:
                    from .checkpoint import save_variables

                    save_variables(checkpoint_path, result)
                    print(f"[train] saved best ({err:.3f} px) -> {checkpoint_path}", flush=True)
    return result if result is not None else panet.to_jax_variables(model)


def main(argv=None) -> None:
    """Training CLI: writes a framework checkpoint (.msgpack)."""
    import argparse

    parser = argparse.ArgumentParser(description="train the patch-alignment flow CNN")
    parser.add_argument("--num_steps", type=int, default=2000)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--image_dir", default=None, help="real images (default: synthetic textures)")
    parser.add_argument("--corpus", default="synthetic", choices=["synthetic", "real"],
                        help="'real' uses locally bundled photos/textures (utils.corpus)")
    parser.add_argument("--warp", action="store_true", help="similarity-warped targets + noise")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", required=True, help="checkpoint path (.msgpack)")
    parser.add_argument("--holdout", nargs="*", default=list(DEFAULT_HOLDOUT),
                        help="path substrings excluded from the real corpus (validation set)")
    parser.add_argument("--occlusion_prob", type=float, default=0.0,
                        help="occlusion-augmentation rate for warped sampling")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    variables = train(
        num_steps=args.num_steps,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        image_dir=args.image_dir,
        corpus=args.corpus,
        warp=args.warp,
        seed=args.seed,
        checkpoint_path=args.output,
        holdout=tuple(args.holdout),
        occlusion_prob=args.occlusion_prob,
        device=args.device,
    )
    from .checkpoint import save_variables

    save_variables(args.output, variables)
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
