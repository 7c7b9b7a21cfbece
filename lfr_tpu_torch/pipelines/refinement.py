"""Coarse-to-fine two-view match refinement (port of
lfr_tpu/pipelines/refinement.py).

A symmetric single-center pass at the image's own scale, then an asymmetric
3x3-grid pass per direction on 2x-upsampled images re-centered by the coarse
estimate (displacement unit = 16 px, grid = +-8 px at the original scale,
fine result halved).  Images are padded and upsampled on the device once
(:func:`prepare_image`) and every stage stays there; the host sees only the
final flow grids.

Per chunk of matches the CNN runs one symmetric correlation launch (coarse
pass, batch N) and nine asymmetric ones (fine pass, batch 2N, both
directions at once), in either fine mode:

* ``"grid"``: nine independent 33x33 patches per direction on the
  ps/(ps-1)-spaced sampling grid, each through the full CNN;
* ``"crop"``: one unit-lattice 65x65 crop per direction runs the backbone
  once, the nine 17x17 feature windows are slices of its feature map, and
  the flow is rescaled by (ps-1)/ps for the unit lattice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT_BATCH_SIZE, DISPLACEMENT_UNIT_PX, GRID_OFFSET_PX, PATCH_SIZE
from ..device import resolve_device
from ..models import panet
from ..ops import matchers
from ..ops.image_ops import pyr_up
from ..ops.patches import (
    REFLECT_MARGIN,
    extract_crops_unit,
    extract_patch_grid_separable,
    extract_patches_separable,
)

#: Image dims are padded up to multiples of this.
IMAGE_BUCKET = 256


def pad_image(image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (H, W, C) to the next shape bucket; returns (padded, valid_hw)."""
    h, w = image.shape[:2]
    ph = -(-h // IMAGE_BUCKET) * IMAGE_BUCKET
    pw = -(-w // IMAGE_BUCKET) * IMAGE_BUCKET
    out = np.zeros((ph, pw) + image.shape[2:], dtype=image.dtype)
    out[:h, :w] = image
    return out, np.array([h, w], dtype=np.int32)


def _bucket_dims(h: int, w: int, margin: int) -> Tuple[int, int]:
    ph = -(-(h + 2 * margin) // IMAGE_BUCKET) * IMAGE_BUCKET
    pw = -(-(w + 2 * margin) // IMAGE_BUCKET) * IMAGE_BUCKET
    return ph, pw


def _reflect_bucket(image: torch.Tensor, margin: int, bucket_h: int, bucket_w: int):
    """Reflect-101 pad by ``margin`` then zero-pad to (bucket_h, bucket_w)."""
    chw = image.permute(2, 0, 1)[None]
    reflected = F.pad(chw, (margin, margin, margin, margin), mode="reflect")[0]
    out = torch.zeros((bucket_h, bucket_w, image.shape[2]), dtype=torch.float32,
                      device=image.device)
    out[: reflected.shape[1], : reflected.shape[2]] = reflected.permute(1, 2, 0)
    return out


def _prep_image(raw: torch.Tensor, margin: int, bucket_h: int, bucket_w: int):
    """Reflect-pad + bucket-pad (raw uint8 in, f32 out)."""
    return _reflect_bucket(raw.float(), margin, bucket_h, bucket_w)


def _prep_image_up(raw: torch.Tensor, margin: int, bucket_h: int, bucket_w: int):
    """2x Gaussian upsample + reflect/bucket pad."""
    return _reflect_bucket(pyr_up(raw), margin, bucket_h, bucket_w)


def _extend(arr: torch.Tensor, h: int, w: int) -> torch.Tensor:
    out = torch.zeros((h, w, arr.shape[2]), dtype=arr.dtype, device=arr.device)
    out[: arr.shape[0], : arr.shape[1]] = arr
    return out


def _harmonize(a: "_DeviceImage", b: "_DeviceImage"):
    """Zero-extend two device images to a shared shape.  The extractors clamp
    their windows to the array's shape, so this keeps the sampling identical
    to the JAX path, which needs equal shapes; the extension is never read."""
    h = max(a.array.shape[0], b.array.shape[0])
    w = max(a.array.shape[1], b.array.shape[1])
    arr_a = a.array if tuple(a.array.shape[:2]) == (h, w) else _extend(a.array, h, w)
    arr_b = b.array if tuple(b.array.shape[:2]) == (h, w) else _extend(b.array, h, w)
    return arr_a, arr_b


class _DeviceImage:
    """An image reflect-padded and bucket-padded on the device, with the
    margin offset that turns image coordinates into padded coordinates."""

    def __init__(self, image: np.ndarray, device: torch.device, upsample: bool = False):
        h, w = image.shape[:2]
        if upsample:
            h, w = 2 * h, 2 * w
        margin = int(min(REFLECT_MARGIN, h - 1, w - 1))
        ph, pw = _bucket_dims(h, w, margin)
        raw = torch.from_numpy(np.ascontiguousarray(image)).to(device)
        prep = _prep_image_up if upsample else _prep_image
        self.array = prep(raw, margin, ph, pw)
        self.offset = float(margin)


class PreparedImage:
    """Device-resident form of one image: the padded base level and the 2x
    pyramid level of the fine pass.  Prepare an image once and reuse it
    across the pairs it takes part in."""

    def __init__(self, image: np.ndarray, device="cuda"):
        self.device = resolve_device(device)
        self.base = _DeviceImage(image, self.device)
        self.up = _DeviceImage(image, self.device, upsample=True)


def prepare_image(image, device="cuda") -> PreparedImage:
    """(H, W, 3) uint8 array -> :class:`PreparedImage` (returned as is when
    already prepared on ``device``)."""
    if isinstance(image, PreparedImage):
        if image.device != resolve_device(device):
            raise ValueError(f"image was prepared on {image.device}, not on {device}")
        return image
    return PreparedImage(image, device)


def _scalar(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


class TwoViewRefiner:
    """Runs the patch-alignment CNN coarse-to-fine over matched keypoints.

    ``variables``: a PANet tree in the JAX layout, as read by
    :func:`lfr_tpu_torch.models.checkpoint.load_variables`.  A tree with
    ``batch_stats`` is BN-folded and normalisation-folded here; a tree
    without is taken to be folded already (as in the JAX refiner)."""

    def __init__(
        self,
        variables,
        batch_size: int = DEFAULT_BATCH_SIZE,
        compute_dtype: torch.dtype = torch.bfloat16,
        fine_mode: str = "grid",
        device="cuda",
    ):
        if fine_mode not in ("grid", "crop"):
            raise ValueError(f"fine_mode must be 'grid' or 'crop', got {fine_mode!r}")
        if variables is None:
            raise ValueError("variables are required: load them with models.checkpoint")
        self.device = resolve_device(device)
        self.fine_mode = fine_mode
        self.batch_size = int(batch_size)
        if "batch_stats" in variables:
            variables = panet.fold_bn_variables(variables)
            variables = panet.fold_normalize_variables(variables)
        model = panet.PANet(compute_dtype)
        model.load_state_dict(panet.from_jax_variables(variables))
        self.model = model.to(self.device).eval().requires_grad_(False)
        self._fine_both = self._fine_grid if fine_mode == "grid" else self._fine_crop

    @staticmethod
    def _fine_targets(ij1, ij2, c12, c21, off1, off2):
        """Centers of the fine pass on the 2x images: (src12, tgt12, src21, tgt21)."""
        src12 = 2.0 * ij1 + off1
        tgt12 = 2.0 * (ij2 + c12 * DISPLACEMENT_UNIT_PX) + off2
        src21 = 2.0 * ij2 + off2
        tgt21 = 2.0 * (ij1 + c21 * DISPLACEMENT_UNIT_PX) + off1
        return src12, tgt12, src21, tgt21

    @staticmethod
    def _split_directions(disp: torch.Tensor, n: int):
        """(9, 2N, 2) per-offset flows -> two (N, 3, 3, 2) grids."""
        fine12 = disp[:, :n].transpose(0, 1).reshape(-1, 3, 3, 2)
        fine21 = disp[:, n:].transpose(0, 1).reshape(-1, 3, 3, 2)
        return fine12, fine21

    def _fine_grid(self, up1, up2, ij1, ij2, c12, c21, off1, off2, k1=None, k2=None):
        """Both fine directions: all 4 x 9 patch grids up front, then the
        asym CNN over both directions at once for each of the 9 offsets.
        With ``k1``/``k2``, ``up1``/``up2`` are image stacks and each match
        reads its own images."""
        g = int(2.0 * GRID_OFFSET_PX)  # +-16 px on the 2x image
        src12, tgt12, src21, tgt21 = self._fine_targets(ij1, ij2, c12, c21, off1, off2)
        srcs = torch.cat([
            extract_patch_grid_separable(up1, src12, g, PATCH_SIZE, img_idx=k1),
            extract_patch_grid_separable(up2, src21, g, PATCH_SIZE, img_idx=k2),
        ])  # (2N, 9, ps, ps, 3)
        tgts = torch.cat([
            extract_patch_grid_separable(up2, tgt12, g, PATCH_SIZE, img_idx=k2),
            extract_patch_grid_separable(up1, tgt21, g, PATCH_SIZE, img_idx=k1),
        ])
        disp = torch.stack([self.model(srcs[:, k], tgts[:, k]) for k in range(9)])
        return self._split_directions(disp, ij1.shape[0])

    def _fine_crop(self, up1, up2, ij1, ij2, c12, c21, off1, off2, k1=None, k2=None):
        """Crop-feature fine pass: the backbone once per 65 px crop, then the
        9 offsets over correlation + head on slices of its feature map."""
        g = int(2.0 * GRID_OFFSET_PX)
        crop = PATCH_SIZE + 2 * g  # 65
        src12, tgt12, src21, tgt21 = self._fine_targets(ij1, ij2, c12, c21, off1, off2)
        crops = torch.cat([
            extract_crops_unit(up1, src12, crop, img_idx=k1),
            extract_crops_unit(up2, src21, crop, img_idx=k2),
            extract_crops_unit(up2, tgt12, crop, img_idx=k2),
            extract_crops_unit(up1, tgt21, crop, img_idx=k1),
        ])  # (4N, 65, 65, 3)
        fmaps = self.model.features(crops)  # (4N, 33, 33, C)
        n = ij1.shape[0]
        fsrc, ftgt = fmaps[: 2 * n], fmaps[2 * n :]
        fdim = panet.FMAP
        step_px = g // 2  # 16 px on the image = 8 feature rows (stride 2)
        disp = []
        for k in range(9):
            a, b = (k // 3) * step_px, (k % 3) * step_px
            fs = fsrc[:, a : a + fdim, b : b + fdim].contiguous()
            ft = ftgt[:, a : a + fdim, b : b + fdim].contiguous()
            disp.append(self.model.flow_from_features(fs, ft))
        # Unit-lattice calibration (lfr_tpu/pipelines/refinement.py:344).
        disp = torch.stack(disp) * ((PATCH_SIZE - 1.0) / PATCH_SIZE)
        return self._split_directions(disp, n)

    def _refine_full(self, im1, im2, up1, up2, ij1, ij2, o1, o2, ou1, ou2, k1=None, k2=None):
        """Coarse symmetric pass feeding the fine pass, all on the device.
        With ``k1``/``k2`` the images are stacks indexed per match.

        On the card a short batch runs at the full batch's shapes, its last
        match repeated: cuDNN builds its fused convs anew for each new shape
        (about 0.7 s a layer, PERF.md), and the matches are independent."""
        n = ij1.shape[0]
        if ij1.is_cuda and 0 < n < self.batch_size:
            def full(t):
                if t is None or t.dim() == 0:
                    return t
                return torch.cat([t, t[-1:].expand((self.batch_size - n,) + t.shape[1:])])

            grid12, grid21 = self._refine_full(
                im1, im2, up1, up2, *map(full, (ij1, ij2, o1, o2, ou1, ou2, k1, k2)))
            return grid12[:n], grid21[:n]
        p1 = extract_patches_separable(im1, ij1 + o1, PATCH_SIZE, img_idx=k1)
        p2 = extract_patches_separable(im2, ij2 + o2, PATCH_SIZE, img_idx=k2)
        c12, c21 = self.model.forward_sym(p1, p2)
        fine12, fine21 = self._fine_both(up1, up2, ij1, ij2, c12, c21, ou1, ou2, k1, k2)
        grid12 = c12[:, None, None] + 0.5 * fine12
        grid21 = c21[:, None, None] + 0.5 * fine21
        return grid12, grid21

    # ------------------------------------------------------------------
    # Matching, per pair and over a descriptor stack.
    # ------------------------------------------------------------------

    @staticmethod
    def _match_only(d1, d2, n1, n2, threshold, matcher: str) -> torch.Tensor:
        """Matching alone on padded device descriptors (..., B1, D) x
        (..., B2, D), packed as (..., B1, 3) f32 [nn12, sim, keep] so that
        one copy brings it to the host."""
        nn12, msim, keep = matchers.match_padded(d1, d2, n1, n2, threshold, matcher)
        return torch.stack([nn12.float(), msim, keep.float()], dim=-1)

    def _match_stack(self, dstack, s1, s2, n1, n2, thr, matcher: str) -> torch.Tensor:
        """P pairs of descriptor-stack slots matched in one batched product:
        (S, B, D) stack, (P,) slots, counts and thresholds -> (P, B, 3)."""
        return self._match_only(dstack[s1], dstack[s2], n1, n2, thr, matcher)

    # ------------------------------------------------------------------
    # Cross-pair batches over image stacks (pipelines.stream).
    # ------------------------------------------------------------------

    def _refine_batch(self, base, up, k1, k2, ij1, ij2, ob1, ob2, ou1, ou2):
        """Coarse-to-fine refinement of one batch of matches drawn from many
        pairs over the base and 2x image stacks (S, H, W, 3): match n reads
        images ``k1[n]`` and ``k2[n]``, whose margin offsets are ``ob*[n]``
        and ``ou*[n]``.  Returns (grid12, grid21), each (N, 3, 3, 2) on the
        device."""
        with torch.inference_mode():
            return self._refine_full(
                base, base, up, up, ij1, ij2, ob1[:, None], ob2[:, None],
                ou1[:, None], ou2[:, None], k1, k2,
            )

    # ------------------------------------------------------------------
    # Per pair: matching and refinement in one call.
    # ------------------------------------------------------------------

    def _match_and_refine(self, d1, d2, n1, n2, threshold, kp1, kp2,
                          im1, im2, up1, up2, o1, o2, ou1, ou2, matcher: str):
        """Match one pair on the device, then refine every match in chunks
        of ``batch_size``.  Returns (idx1, idx2, sims, [(grid12, grid21)
        per chunk]), all on the device.  The count of matches is read on
        the host to size the chunks, so no capacity is needed."""
        packed = self._match_only(d1, d2, n1, n2, threshold, matcher)[:n1]
        idx1 = torch.nonzero(packed[:, 2] > 0).flatten()
        idx2 = packed[idx1, 0].long()
        sims = packed[idx1, 1]
        ij1 = kp1[idx1].flip(-1)  # (x, y) -> (i, j)
        ij2 = kp2[idx2].flip(-1)
        parts = []
        with torch.inference_mode():
            for start in range(0, idx1.shape[0], self.batch_size):
                stop = start + self.batch_size
                parts.append(self._refine_full(
                    im1, im2, up1, up2, ij1[start:stop], ij2[start:stop], o1, o2, ou1, ou2
                ))
        return idx1, idx2, sims, parts

    def process_pair(self, image1, keypoints1, descriptors1, image2, keypoints2,
                     descriptors2, matcher: str, threshold: float):
        """Enqueue matching and coarse-to-fine refinement of one pair.

        ``image1``/``image2`` are raw (H, W, 3) uint8 arrays or
        :class:`PreparedImage` handles; keypoints (K, >=2) x, y at this
        scale; descriptors (K, D).  Returns a handle for
        :meth:`finalize_pair`.  Every match is refined: there is no match
        capacity to outgrow."""
        dev = self.device
        d1, n1 = matchers._pad_descriptors(np.asarray(descriptors1, np.float32))
        d2, n2 = matchers._pad_descriptors(np.asarray(descriptors2, np.float32))
        kp1 = torch.as_tensor(np.asarray(keypoints1)[:, :2], dtype=torch.float32).to(dev)
        kp2 = torch.as_tensor(np.asarray(keypoints2)[:, :2], dtype=torch.float32).to(dev)
        prep1 = prepare_image(image1, dev)
        prep2 = prepare_image(image2, dev)
        im1, im2 = _harmonize(prep1.base, prep2.base)
        up1, up2 = _harmonize(prep1.up, prep2.up)
        kind = "similarity" if matcher == "similarity" else "ratio"
        return self._match_and_refine(
            torch.from_numpy(d1).to(dev), torch.from_numpy(d2).to(dev), n1, n2,
            float(threshold), kp1, kp2, im1, im2, up1, up2,
            _scalar(prep1.base.offset, dev), _scalar(prep2.base.offset, dev),
            _scalar(prep1.up.offset, dev), _scalar(prep2.up.offset, dev), kind,
        )

    @staticmethod
    def finalize_pair(pending):
        """Resolve a :meth:`process_pair` handle -> (matches (N, 2) int64,
        sims (N,) f32, grid12, grid21 (N, 3, 3, 2) f32)."""
        idx1, idx2, sims, parts = pending
        matches = torch.stack([idx1, idx2], dim=1).cpu().numpy().astype(np.int64)
        if parts:
            grid12, grid21 = TwoViewRefiner.resolve_refined(("parts", parts))
        else:
            grid12 = grid21 = np.zeros((0, 3, 3, 2), np.float32)
        return matches, sims.cpu().numpy().astype(np.float32), grid12, grid21

    def refine_matches_async(self, image1, keypoints1, image2, keypoints2, matches):
        """Enqueue the refinement of every match without waiting for it.

        Returns a handle for :meth:`resolve_refined`.  ``image1``/``image2``
        may be raw (H, W, 3) uint8 arrays or :class:`PreparedImage` handles."""
        if matches.shape[0] == 0:
            z = np.zeros((0, 3, 3, 2), dtype=np.float32)
            return ("ready", (z, z))
        ij1 = keypoints1[matches[:, 0]][:, [1, 0]].astype(np.float64)
        ij2 = keypoints2[matches[:, 1]][:, [1, 0]].astype(np.float64)
        prep1 = prepare_image(image1, self.device)
        prep2 = prepare_image(image2, self.device)
        up1, up2 = _harmonize(prep1.up, prep2.up)
        dev = self.device
        o1, o2 = _scalar(prep1.base.offset, dev), _scalar(prep2.base.offset, dev)
        ou1, ou2 = _scalar(prep1.up.offset, dev), _scalar(prep2.up.offset, dev)
        parts = []
        with torch.inference_mode():
            for start in range(0, ij1.shape[0], self.batch_size):
                stop = start + self.batch_size
                c1 = torch.as_tensor(ij1[start:stop], dtype=torch.float32).to(dev)
                c2 = torch.as_tensor(ij2[start:stop], dtype=torch.float32).to(dev)
                parts.append(self._refine_full(
                    prep1.base.array, prep2.base.array, up1, up2, c1, c2, o1, o2, ou1, ou2
                ))
        return ("parts", parts)

    @staticmethod
    def resolve_refined(handle) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a :meth:`refine_matches_async` handle -> (grid12, grid21)."""
        kind, payload = handle
        if kind == "ready":
            return payload
        grid12 = torch.cat([g12 for g12, _ in payload]).cpu().numpy()
        grid21 = torch.cat([g21 for _, g21 in payload]).cpu().numpy()
        return grid12, grid21

    def refine_matches(self, image1, keypoints1, image2, keypoints2, matches):
        """Coarse-to-fine refinement of matched keypoints.

        Args:
          image1/image2: (H, W, 3) uint8 RGB or :class:`PreparedImage`.
          keypoints1/keypoints2: (K, >=2) with x, y columns at this scale.
          matches: (N, 2) indices into the keypoint arrays.

        Returns (grid12, grid21): (N, 3, 3, 2) flow grids in displacement
        units (1 unit = 16 px), sampled at +-8 px around the source keypoint.
        """
        return self.resolve_refined(
            self.refine_matches_async(image1, keypoints1, image2, keypoints2, matches)
        )
