"""Incremental structure-from-motion mapper (port of lfr_tpu/sfm/mapper.py).

In-framework replacement for ``colmap mapper``
(reference: reconstruction-scripts/colmap_utils.py:226-294): initialize
from the strongest verified pair (RANSAC essential), then alternate PnP
registration, batched triangulation, LOCAL bundle adjustment around each
new camera, periodic global BA + retriangulation + track completion —
with the dense linear algebra in torch on the device (``device=``, the
card by default) and the irregular bookkeeping on the host as flat numpy
arrays, copied from the JAX package.

Differences from the JAX package by design:

- RANSAC samples come from a *sample source* (:class:`CpuSamples` by
  default: CPU generators seeded per call, the same on every device), where
  JAX draws with ``jax.random`` under fixed keys.  The source is a test
  seam: the parity tests pass one that returns JAX's own indices;
- the homography decomposition is numpy (:func:`decompose_homography`,
  OpenCV's algorithm and candidate order), where JAX calls
  ``cv2.decomposeHomographyMat``;
- the DLT triangulations and the F / H RANSAC of the initialization run
  the port's batched torch functions; the init matches are padded to
  JAX's power-of-two bucket, since the refits normalise over every padded
  row; the other batches are not padded (their rows are independent).

Bookkeeping is array-based for scale: features are globally indexed
(``base[iid] + feat``), point assignments live in one ``pid_of_g`` array,
and the correspondence graph is CSR (``corr_start`` / ``corr_nbr``), so
registration scans, track completion, and filtering are vectorized numpy
passes instead of per-feature dict loops.

Scope notes vs COLMAP: intrinsics stay fixed at their priors unless
``refine_focal`` (the reference's triangulation benchmark also fixes
them, colmap_utils.py:302-311); a single camera model per image is
assumed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from ..device import resolve_device
from ..io import colmap_db as db_mod
from ..io import colmap_model as model_mod
from ..utils.timing import Accum
from . import ba as ba_mod
from . import cameras as cam_mod
from . import geometry, pnp, verify
from .triangulate import analyze_model


def _opposite_of_minor(M: np.ndarray, row: int, col: int) -> float:
    x1 = 1 if col == 0 else 0
    x2 = 1 if col == 2 else 2
    y1 = 1 if row == 0 else 0
    y2 = 1 if row == 2 else 2
    return M[y1, x2] * M[y2, x1] - M[y1, x1] * M[y2, x2]


def _sign(x: float) -> float:
    return 1.0 if x >= 0 else -1.0


def decompose_homography(H: np.ndarray):
    """The motions of a calibrated homography (K = I), as OpenCV's
    ``decomposeHomographyMat`` returns them, in its order: (rotations,
    translations, normals), each a list of 4 (of 1, with t = n = 0, when H
    is a rotation).

    Malis & Vargas, "Deeper understanding of the homography decomposition
    for vision-based control" (INRIA RR-6303, 2007), as OpenCV implements it
    (``HomographyDecompInria``): H is scaled by its second singular value,
    S = HᵀH - I, the two plane normals come from the row of S with the
    largest |S_ii| and the opposites of S's minors, and the four motions are
    (Ra, ta, na), (Ra, -ta, -na), (Rb, tb, nb), (Rb, -tb, -nb)."""
    Hn = np.asarray(H, np.float64)
    Hn = Hn / np.linalg.svd(Hn, compute_uv=False)[1]
    S = Hn.T @ Hn - np.eye(3)
    if np.abs(S).max() < 1e-3:  # H is a rotation (OpenCV: NORM_INF < 0.001)
        return [Hn], [np.zeros(3)], [np.zeros(3)]
    m00 = _opposite_of_minor(S, 0, 0)
    m11 = _opposite_of_minor(S, 1, 1)
    m22 = _opposite_of_minor(S, 2, 2)
    rt00, rt11, rt22 = np.sqrt(m00), np.sqrt(m11), np.sqrt(m22)
    e12 = _sign(_opposite_of_minor(S, 1, 2))
    e02 = _sign(_opposite_of_minor(S, 0, 2))
    e01 = _sign(_opposite_of_minor(S, 0, 1))
    a = np.abs(np.diag(S))
    if a[0] < a[1]:
        indx = 2 if a[1] < a[2] else 1
    else:
        indx = 2 if a[0] < a[2] else 0
    if indx == 0:
        npa = np.array([S[0, 0], S[0, 1] + rt22, S[0, 2] + e12 * rt11])
        npb = np.array([S[0, 0], S[0, 1] - rt22, S[0, 2] - e12 * rt11])
    elif indx == 1:
        npa = np.array([S[0, 1] + rt22, S[1, 1], S[1, 2] - e02 * rt00])
        npb = np.array([S[0, 1] - rt22, S[1, 1], S[1, 2] + e02 * rt00])
    else:
        npa = np.array([S[0, 2] + e01 * rt11, S[1, 2] + rt00, S[2, 2]])
        npb = np.array([S[0, 2] - e01 * rt11, S[1, 2] - rt00, S[2, 2]])
    trace = S[0, 0] + S[1, 1] + S[2, 2]
    v = 2.0 * np.sqrt(1.0 + trace - m00 - m11 - m22)
    esii = _sign(S[indx, indx])
    r = np.sqrt(2.0 + trace + v)
    n_t = np.sqrt(2.0 + trace - v)
    na = npa / np.linalg.norm(npa)
    nb = npb / np.linalg.norm(npb)
    half_nt = 0.5 * n_t
    esii_r = esii * r
    ta_star = half_nt * (esii_r * nb - n_t * na)
    tb_star = half_nt * (esii_r * na - n_t * nb)

    def rotation(tstar, n):
        R = Hn @ (np.eye(3) - (2.0 / v) * np.outer(tstar, n))
        return -R if np.linalg.det(R) < 0 else R

    Ra, Rb = rotation(ta_star, na), rotation(tb_star, nb)
    ta, tb = Ra @ ta_star, Rb @ tb_star
    return [Ra, Ra, Rb, Rb], [ta, -ta, tb, -tb], [na, -na, nb, -nb]


@dataclasses.dataclass
class MapperOptions:
    init_min_tri_angle_deg: float = 6.0
    init_min_num_inliers: int = 50
    abs_pose_min_num_inliers: int = 15
    max_reproj_error_px: float = 4.0
    min_tri_angle_deg: float = 1.5
    #: Fixed global-BA interval (registrations between global rounds).
    #: ``None`` (default) uses the GEOMETRIC schedule: global BA when the
    #: model has grown by ``ba_global_ratio`` since the last one — the
    #: colmap-mapper scaling behavior (frequent while the model is small,
    #: sparse once it is large; an every-K schedule is O(n^2/K) total BA
    #: work over an n-image run, the geometric one is O(n)).
    ba_global_every: Optional[int] = None
    #: Growth factor of the geometric global-BA schedule.
    ba_global_ratio: float = 1.1
    ba_iterations: int = 25
    ba_local_iterations: int = 12
    #: Relative cost-decrease stop for INTERMEDIATE global BAs (the final
    #: polish always runs at 1e-6).  Mid-run structure only needs to be
    #: good enough for the next registrations; the loose stop saves
    #: ~half the LM iterations per round at identical end quality.
    ba_intermediate_tol: float = 1e-4
    #: Covisible registered cameras freed in each local BA.
    local_ba_neighbors: int = 5
    min_track_len: int = 2
    #: Refine per-view focal scales in BA (sensible when each image has its
    #: own camera, e.g. EXIF-bootstrapped databases).
    refine_focal: bool = False
    #: Maximum number of disconnected models to reconstruct (the reference
    #: keeps every model colmap produces and selects the largest,
    #: colmap_utils.py:238-264).
    max_models: int = 10
    #: A (non-first) model must register at least this many images to be
    #: kept when sweeping the disconnected remainder.
    min_model_size: int = 3


class CpuSamples:
    """The mapper's default sample source: the port's CPU generators under
    seed 0 for every call, so a given (valid, padded) size always draws the
    same samples, on every device (JAX likewise draws under fixed keys:
    PRNGKey(0) for F, PRNGKey(1) for H and PRNGKey(0) for every PnP)."""

    def fundamental(self, n_valid: int, n_padded: int) -> torch.Tensor:
        return verify.sample_indices(0, 0, n_valid, n_padded)[0]

    def homography(self, n_valid: int, n_padded: int) -> torch.Tensor:
        return verify.sample_indices(0, 0, n_valid, n_padded)[1]

    def pnp(self, n_valid: int, n_padded: int) -> torch.Tensor:
        return pnp.sample_indices(0, n_valid, n_padded)


class IncrementalMapper:
    def __init__(
        self,
        database: db_mod.ColmapDatabase,
        options: MapperOptions = None,
        device="cuda",
        samples=None,
    ):
        self.opt = options or MapperOptions()
        self.device = resolve_device(device)
        #: Sample source (:class:`CpuSamples`): ``fundamental``,
        #: ``homography`` and ``pnp`` (n_valid, n_padded) -> indices.
        self.samples = samples or CpuSamples()
        self.db = database
        self.cameras = database.cameras()
        self.image_info = {}  # image_id -> name
        for name, iid in database.image_ids().items():
            self.image_info[iid] = name
        self.image_cam = database.image_cameras()

        # Per-image data + global feature indexing.
        self.kp: Dict[int, np.ndarray] = {}
        self.norm_uv: Dict[int, np.ndarray] = {}
        self.focal: Dict[int, float] = {}
        self.base: Dict[int, int] = {}
        self.iids: List[int] = sorted(self.image_info)
        offset = 0
        for iid in self.iids:
            kp = database.keypoints(iid)
            self.kp[iid] = kp
            cam_row = self.cameras[self.image_cam[iid]]
            cam = model_mod.Camera(
                cam_row["camera_id"],
                db_mod.CAMERA_MODEL_NAMES[cam_row["model"]],
                cam_row["width"],
                cam_row["height"],
                cam_row["params"],
            )
            if kp.shape[0]:
                self.norm_uv[iid] = cam_mod.pixel_to_normalized(
                    cam, kp[:, :2].astype(np.float64)
                )
            else:
                self.norm_uv[iid] = np.zeros((0, 2))
            self.focal[iid] = float(cam_mod.calibration_matrix(cam)[0, 0])
            self.base[iid] = offset
            offset += kp.shape[0]
        self.total = offset
        # Owner image (as index into self.iids) of every global feature.
        self.img_of_g = np.zeros(self.total, np.int64)
        self.iid_index = {iid: k for k, iid in enumerate(self.iids)}
        for iid in self.iids:
            b = self.base[iid]
            self.img_of_g[b : b + self.kp[iid].shape[0]] = self.iid_index[iid]
        # Flat normalized coords + per-feature focal for batch reprojection.
        self.uv_g = (
            np.concatenate([self.norm_uv[i] for i in self.iids])
            if self.total
            else np.zeros((0, 2))
        )
        self.focal_g = np.concatenate(
            [np.full(self.kp[i].shape[0], self.focal[i]) for i in self.iids]
        ) if self.total else np.zeros(0)

        # Verified matches per pair + CSR correspondence graph over gids.
        self.pair_matches: Dict[Tuple[int, int], np.ndarray] = {}
        self.pair_config: Dict[Tuple[int, int], int] = {}
        src_all, dst_all = [], []
        for id1, id2, m, config in database.all_two_view_geometries():
            if m.shape[0] == 0:
                continue
            self.pair_matches[(id1, id2)] = m
            self.pair_config[(id1, id2)] = int(config)
            g1 = self.base[id1] + m[:, 0].astype(np.int64)
            g2 = self.base[id2] + m[:, 1].astype(np.int64)
            src_all.extend([g1, g2])
            dst_all.extend([g2, g1])
        if src_all:
            src = np.concatenate(src_all)
            dst = np.concatenate(dst_all)
            order = np.argsort(src, kind="stable")
            self.corr_nbr = dst[order]
            self.corr_start = np.searchsorted(
                src[order], np.arange(self.total + 1)
            )
        else:
            self.corr_nbr = np.zeros(0, np.int64)
            self.corr_start = np.zeros(self.total + 1, np.int64)

        # Reconstruction state.  Per-point state is FLAT ARRAYS indexed by
        # pid (the dict/list-of-tuples track store was the superlinear
        # term at 100+ cameras): positions in ``X``, liveness in
        # ``_pid_live``, observation counts in ``track_len``; the tracks
        # themselves are implicit in ``pid_of_g`` (all gids assigned to a
        # pid) and recovered by vectorized grouping where needed.
        self.registered: List[int] = []
        self.registered_mask = np.zeros(len(self.iids), bool)
        self.reg_rank: Dict[int, int] = {}  # iid -> registration order
        self.R: Dict[int, np.ndarray] = {}
        self.t: Dict[int, np.ndarray] = {}
        self.pid_of_g = np.full(self.total, -1, np.int64)
        self.next_pid = 1
        cap = 1024
        self._pid_live = np.zeros(cap, bool)
        self.X = np.zeros((cap, 3))
        self.track_len = np.zeros(cap, np.int32)
        self.n_points = 0
        #: (pid, image) co-membership as ``pid * n_images + img_idx`` ints:
        #: O(1) image-disjointness checks (<=1 feature per image per track)
        #: without per-track Python sets.
        self.pair_set: set = set()
        #: Images eligible for this reconstruction (multi-model sweeps
        #: exclude images already registered in earlier models).
        self.allowed_mask = np.ones(len(self.iids), bool)
        # Incremental registration-candidate ranking: per feature, the
        # number of ASSIGNED correspondents; per image, the number of
        # unassigned features with >= 1 assigned correspondent.  Updated
        # on every (un)assignment in O(degree) instead of recomputing an
        # O(E) pass over the whole correspondence graph per registration
        # round (~100 full passes over 1M+ entries at 100 cameras).
        self.nbr_assigned = np.zeros(self.total, np.int32)
        self.per_img_cand = np.zeros(len(self.iids), np.int64)
        # Per-phase wall-clock attribution (PnP / triangulation / local BA /
        # global BA / filtering / retriangulation / completion) — the
        # reference's per-stage chrono prints (solve.cc:585-641) applied to
        # the mapper, so scale runs report where reconstruction time goes.
        self.phases = Accum()

    # -- assignment helpers ------------------------------------------------

    def _gid(self, iid: int, feat: int) -> int:
        return self.base[iid] + feat

    def _nbrs(self, gid: int) -> np.ndarray:
        return self.corr_nbr[self.corr_start[gid] : self.corr_start[gid + 1]]

    def _rank_on_assign(self, gid: int) -> None:
        """Candidate-ranking bookkeeping when ``gid`` becomes assigned."""
        if self.nbr_assigned[gid] > 0:
            # gid itself leaves the candidate set of its image.
            self.per_img_cand[self.img_of_g[gid]] -= 1
        nbrs = self._nbrs(gid)
        if nbrs.size:
            old = self.nbr_assigned[nbrs]
            self.nbr_assigned[nbrs] = old + 1
            became = (old == 0) & (self.pid_of_g[nbrs] < 0)
            if became.any():
                np.add.at(self.per_img_cand, self.img_of_g[nbrs[became]], 1)

    def _assign(self, iid: int, feat: int, pid: int) -> None:
        gid = self.base[iid] + feat
        self.pid_of_g[gid] = pid
        self.track_len[pid] += 1
        self.pair_set.add(pid * len(self.iids) + self.iid_index[iid])
        self._rank_on_assign(gid)

    def _track_has_image(self, pid: int, iid: int) -> bool:
        return (pid * len(self.iids) + self.iid_index[iid]) in self.pair_set

    def _grow_points(self, need: int) -> None:
        cap = self._pid_live.shape[0]
        new_cap = max(need + 1, 2 * cap)
        for name in ("_pid_live", "track_len"):
            grown = np.zeros(new_cap, getattr(self, name).dtype)
            grown[:cap] = getattr(self, name)
            setattr(self, name, grown)
        grown = np.zeros((new_cap, 3))
        grown[:cap] = self.X
        self.X = grown

    def _new_point(self, X, obs: List[Tuple[int, int]]) -> int:
        pid = self.next_pid
        self.next_pid += 1
        if pid >= self._pid_live.shape[0]:
            self._grow_points(pid)
        self._pid_live[pid] = True
        self.X[pid] = X
        self.track_len[pid] = 0
        self.n_points += 1
        for iid, feat in obs:
            self._assign(iid, feat, pid)
        return pid

    def _unassign_batch(self, gids: np.ndarray) -> None:
        """Batched inverse of ``_assign`` for the filtering passes: clears
        assignments, updates track lengths / pair sets / the incremental
        candidate ranking.  ``gids`` must be currently assigned."""
        if gids.size == 0:
            return
        pids = self.pid_of_g[gids]
        ni = len(self.iids)
        imgs = self.img_of_g[gids]
        self.pair_set.difference_update((pids * ni + imgs).tolist())
        np.subtract.at(self.track_len, pids, 1)
        self.pid_of_g[gids] = -1
        # Ranking: decrement every neighbor's assigned-correspondent
        # count; transitions evaluated on the FINAL counts/assignments.
        counts = self.corr_start[gids + 1] - self.corr_start[gids]
        total_n = int(counts.sum())
        if total_n:
            starts = self.corr_start[gids]
            offs = np.repeat(
                starts - np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
            )
            nbrs_all = self.corr_nbr[np.arange(total_n) + offs]
            u, cnt = np.unique(nbrs_all, return_counts=True)
            old = self.nbr_assigned[u]
            self.nbr_assigned[u] = old - cnt
            # Neighbors that were candidates (unassigned, old > 0) and now
            # have zero assigned correspondents drop out — but members of
            # this batch were ASSIGNED a moment ago (never candidates), so
            # exclude them here; they are handled below.
            in_batch = np.zeros(self.total, bool)
            in_batch[gids] = True
            lost = (old > 0) & (self.nbr_assigned[u] == 0) & (self.pid_of_g[u] < 0)
            lost &= ~in_batch[u]
            if lost.any():
                np.add.at(self.per_img_cand, self.img_of_g[u[lost]], -1)
        # The unassigned gids themselves become candidates if they still
        # have assigned correspondents.
        gained = self.nbr_assigned[gids] > 0
        if gained.any():
            np.add.at(self.per_img_cand, imgs[gained], 1)

    def _reset_reconstruction(self) -> None:
        """Discard all reconstruction state (used to retry initialization
        from a different pair, and between multi-model sweeps)."""
        self.registered = []
        self.registered_mask[:] = False
        self.reg_rank = {}
        self.R = {}
        self.t = {}
        self.pid_of_g[:] = -1
        self._pid_live[:] = False
        self.track_len[:] = 0
        self.n_points = 0
        self.pair_set = set()
        self.nbr_assigned[:] = 0
        self.per_img_cand[:] = 0

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------

    def _try_initialize(self, id1: int, id2: int) -> bool:
        m = self.pair_matches[(id1, id2)]
        if m.shape[0] < self.opt.init_min_num_inliers:
            return False
        x1 = self.norm_uv[id1][m[:, 0]]
        x2 = self.norm_uv[id2][m[:, 1]]

        # RANSAC essential (8-point on normalized coords = E), Sampson
        # threshold scaled from pixels to normalized units (in float32, as
        # JAX traces it).  The inputs pad to JAX's power-of-two bucket: the
        # refits normalise over every padded row, so the padding is part of
        # the result.
        thr = np.float32(self.opt.max_reproj_error_px / max(
            self.focal[id1], self.focal[id2]
        ))
        n = m.shape[0]
        nb = pnp.bucket_size(n)
        x1p = np.zeros((nb, 2), np.float32)
        x2p = np.zeros((nb, 2), np.float32)
        x1p[:n], x2p[:n] = x1, x2
        valid = np.zeros(nb, bool)
        valid[:n] = True
        dev = self.device
        x1t, x2t = torch.from_numpy(x1p).to(dev), torch.from_numpy(x2p).to(dev)
        valid_t = torch.from_numpy(valid).to(dev)
        E, inl, n_inl = verify.ransac_fundamental(
            x1t, x2t, valid_t, self.samples.fundamental(n, nb).to(dev), max_error=thr
        )
        inl = inl.cpu().numpy()[:n]
        if int(n_inl) >= self.opt.init_min_num_inliers:
            eye = torch.eye(3, device=dev)
            E = geometry.essential_from_fundamental(E, eye, eye)
            cands = [
                (R.cpu().numpy(), t.cpu().numpy())
                for R, t in geometry.decompose_essential(E)
            ]
            if self._init_from_candidates(id1, id2, m[inl], x1[inl], x2[inl], cands):
                return True

        # Homography fallback: on planar / quasi-planar pairs the 8-point
        # essential estimate is degenerate (any F of the form [e]x.H fits
        # the dominant plane), so E-based init fails or yields collapsed
        # triangulation angles; colmap recovers the relative pose from the
        # homography there (PoseFromHomographyMatrix, used by its
        # initializer for PLANAR_OR_PANORAMIC pairs).
        H, inl_h, n_h = verify.ransac_homography(
            x1t, x2t, valid_t, self.samples.homography(n, nb).to(dev), max_error=thr
        )
        # Only treat the pair as planar when H explains (almost) as many
        # matches as F — colmap's degeneracy test (H/F inlier ratio >
        # 0.8); otherwise a junk homography on a genuinely 3-D pair could
        # out-commit a failed E candidate with degraded structure.
        if int(n_h) < max(
            self.opt.init_min_num_inliers, int(0.8 * float(n_inl))
        ):
            return False
        inl_h = inl_h.cpu().numpy()[:n]
        cands = self._decompose_homography(H.cpu().numpy())
        if not cands:
            return False
        return self._init_from_candidates(
            id1, id2, m[inl_h], x1[inl_h], x2[inl_h], cands
        )

    @staticmethod
    def _decompose_homography(H: np.ndarray):
        """(R, t) candidates from a calibrated homography (normalized
        coords, so K = I).  Pure-rotation solutions (t ~ 0, panoramic) are
        dropped — they cannot seed structure."""
        H = H / np.linalg.svd(H, compute_uv=False)[1]
        Rs, ts, _ = decompose_homography(H)
        cands = []
        for R, t in zip(Rs, ts):
            t = t.reshape(3)
            nt = np.linalg.norm(t)
            if nt < 1e-6:
                continue  # panoramic: no baseline
            cands.append((np.asarray(R, np.float64), t / nt))
        return cands

    def _init_from_candidates(self, id1, id2, m, x1, x2, cands) -> bool:
        """Score relative-pose candidates by cheirality, gate on the
        triangulation angle, and commit the winning two-view structure."""
        best = None
        T = m.shape[0]
        if T < self.opt.init_min_num_inliers:
            return False
        # Every candidate's cheirality triangulation in one batch.
        uv = np.stack([x1, x2], axis=1)
        P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
        P = np.stack([
            np.stack([P1, np.concatenate([R, t[:, None]], axis=1)]) for R, t in cands
        ])
        Xs = self._triangulate(
            np.broadcast_to(P[:, None], (len(cands), T, 2, 3, 4)),
            np.broadcast_to(uv, (len(cands), T, 2, 2)),
        )
        for (R, t), X in zip(cands, Xs):
            z1 = X[:, 2]
            z2 = (X @ R.T + t)[:, 2]
            good = np.isfinite(X).all(axis=1) & (z1 > 0) & (z2 > 0)
            if best is None or good.sum() > best[3].sum():
                best = (R, t, X, good)
        R, t, X, good = best
        # Cheirality selects the candidate; the pass-count gate is
        # FRACTIONAL (half the inliers + an absolute floor), not the full
        # init_min_num_inliers: wide-baseline pairs on big rigs carry
        # ~50-80 matches of which a noisy minority triangulates behind a
        # camera, and demanding 50 absolute rejected every viable
        # wide-baseline seed at 300 cameras (colmap gates initialization
        # on the PAIR's inlier count; the triangulated-point minimum is
        # enforced by the commit gate below).
        if good.sum() < max(self.opt.abs_pose_min_num_inliers, good.size // 2):
            return False
        # Triangulation angle check (host math; shapes vary per pair).
        c2 = -R.T @ t
        d1 = X[good]
        d2 = X[good] - c2
        cosang = np.sum(d1 * d2, axis=1) / np.maximum(
            np.linalg.norm(d1, axis=1) * np.linalg.norm(d2, axis=1), 1e-12
        )
        ang = np.arccos(np.clip(cosang, -1.0, 1.0))
        if np.median(ang) < np.deg2rad(self.opt.init_min_tri_angle_deg):
            return False

        self.R[id1] = np.eye(3)
        self.t[id1] = np.zeros(3)
        self.R[id2] = R
        self.t[id2] = t
        self.registered = [id1, id2]
        self.reg_rank = {id1: 0, id2: 1}
        self.registered_mask[self.iid_index[id1]] = True
        self.registered_mask[self.iid_index[id2]] = True
        n_before = self.n_points
        for k in np.nonzero(good)[0]:
            f1, f2 = int(m[k, 0]), int(m[k, 1])
            err1 = self._reproj_err(id1, X[k], f1)
            err2 = self._reproj_err(id2, X[k], f2)
            if max(err1, err2) > self.opt.max_reproj_error_px:
                continue
            self._new_point(X[k], [(id1, f1), (id2, f2)])
        # Floor on committed seed points: abs_pose_min_num_inliers (the
        # same minimum a later registration would need), not half of
        # init_min_num_inliers — wide-baseline seeds on big rigs commit
        # ~20-40 points and the dead-end retry in reconstruct() already
        # discards seeds that cannot register a third image.
        if self.n_points - n_before < self.opt.abs_pose_min_num_inliers:
            # Failing AFTER poses/points were created must not leak
            # partial state into the next candidate attempt: a later
            # successful init would inherit tracks referencing these
            # images while `registered` no longer lists them.
            self._reset_reconstruction()
            return False
        return True

    def _triangulate(self, P: np.ndarray, uv: np.ndarray) -> np.ndarray:
        """Two-view DLT points (..., 3) as float32 numpy, from (..., 2, 3, 4)
        projections and (..., 2, 2) normalized observations, on the device
        in float32 (as JAX's ``jnp.asarray`` rounds them)."""
        dev = self.device
        P_t = torch.as_tensor(np.asarray(P, np.float32), device=dev)
        uv_t = torch.as_tensor(np.asarray(uv, np.float32), device=dev)
        mask = torch.ones(uv_t.shape[:-1], dtype=torch.bool, device=dev)
        return geometry.triangulate_dlt(P_t, uv_t, mask).cpu().numpy()

    def _reproj_err(self, iid: int, X: np.ndarray, feat: int) -> float:
        c = self.R[iid] @ X + self.t[iid]
        if c[2] <= 0:
            return np.inf
        proj = c[:2] / c[2]
        return float(np.linalg.norm(proj - self.norm_uv[iid][feat]) * self.focal[iid])

    def _reproj_err_batch(self, gids: np.ndarray, X: np.ndarray) -> np.ndarray:
        """Vectorized reprojection error (px) for observation (gid, X) rows."""
        if gids.size == 0:
            return np.zeros(0)
        img_idx = self.img_of_g[gids]
        uniq = np.unique(img_idx)
        Rs = np.stack([self.R[self.iids[k]] for k in uniq])
        ts = np.stack([self.t[self.iids[k]] for k in uniq])
        local = np.searchsorted(uniq, img_idx)
        c = np.einsum("nab,nb->na", Rs[local], X) + ts[local]
        z = c[:, 2]
        bad = z <= 1e-9
        proj = c[:, :2] / np.where(bad[:, None], 1.0, z[:, None])
        err = np.linalg.norm(proj - self.uv_g[gids], axis=1) * self.focal_g[gids]
        return np.where(bad, np.inf, err)

    # ------------------------------------------------------------------
    # Registration
    # ------------------------------------------------------------------

    def _vote_pids(self, gids_lo: int, gids_hi: int):
        """For every unassigned feature in [lo, hi), majority-vote the pid
        its correspondences map to.  Returns (feat_gids, pids, votes)."""
        lo_ptr = self.corr_start[gids_lo]
        hi_ptr = self.corr_start[gids_hi]
        if hi_ptr == lo_ptr:
            return (np.zeros(0, np.int64),) * 3
        nbr = self.corr_nbr[lo_ptr:hi_ptr]
        counts = np.diff(self.corr_start[gids_lo : gids_hi + 1])
        src = np.repeat(np.arange(gids_lo, gids_hi), counts)
        pids = self.pid_of_g[nbr]
        keep = (pids >= 0) & (self.pid_of_g[src] < 0)
        if not keep.any():
            return (np.zeros(0, np.int64),) * 3
        src, pids = src[keep], pids[keep]
        # Count votes per (src, pid) pair, then argmax per src.
        order = np.lexsort((pids, src))
        src, pids = src[order], pids[order]
        boundary = np.ones(src.size, bool)
        boundary[1:] = (src[1:] != src[:-1]) | (pids[1:] != pids[:-1])
        group_ids = np.cumsum(boundary) - 1
        votes = np.bincount(group_ids)
        g_src = src[boundary]
        g_pid = pids[boundary]
        # Per src, keep the pid with most votes: sort groups by vote count
        # descending, then take each src's first occurrence (np.unique
        # returns first-occurrence indices).
        vorder = np.argsort(-votes, kind="stable")
        fs, ps, vs = g_src[vorder], g_pid[vorder], votes[vorder]
        f, first = np.unique(fs, return_index=True)
        return f, ps[first], vs[first]

    def _visible_points(self, iid: int):
        """2D-3D correspondences for an unregistered image (vectorized)."""
        lo = self.base[iid]
        hi = lo + self.kp[iid].shape[0]
        f, p, _ = self._vote_pids(lo, hi)
        live = self._pid_live[p] if p.size else p.astype(bool)
        f, p = f[live], p[live]
        if f.size == 0:
            return np.zeros((0, 3)), np.zeros((0, 2)), np.zeros((0, 2), np.int64)
        X = self.X[p]
        uv = self.uv_g[f]
        return X, uv, np.stack([f - lo, p], axis=1)

    def _ranking_counts_full(self) -> np.ndarray:
        """O(E) recomputation of the per-image candidate counts — the
        ground truth the incremental ``per_img_cand`` bookkeeping must
        match (kept for tests/debugging)."""
        if self.corr_nbr.size == 0:
            return np.zeros(len(self.iids), np.int64)
        nbr_assigned = (self.pid_of_g[self.corr_nbr] >= 0).astype(np.int64)
        cs = np.concatenate([[0], np.cumsum(nbr_assigned)])
        per_feat = cs[self.corr_start[1:]] - cs[self.corr_start[:-1]]
        cand_feat = (per_feat > 0) & (self.pid_of_g < 0)
        return np.bincount(self.img_of_g[cand_feat], minlength=len(self.iids))

    def _candidate_ranking(self) -> List[int]:
        """Unregistered images ranked by a cheap global upper bound on
        their 2D-3D correspondence count (unassigned features with >= 1
        assigned correspondent).  Reads the incrementally maintained
        ``per_img_cand`` — O(V log V) per round instead of an O(E) pass
        over the whole correspondence graph (E reaches millions at 100+
        cameras and this runs once per registration)."""
        per_img = self.per_img_cand.copy()
        per_img[self.registered_mask] = 0
        per_img[~self.allowed_mask] = 0
        order = np.argsort(-per_img, kind="stable")
        return [
            self.iids[k]
            for k in order
            if per_img[k] >= self.opt.abs_pose_min_num_inliers
        ]

    def _register_next(self) -> Optional[int]:
        # Lazy evaluation in ranked order: the detailed (vote + PnP) pass
        # runs only until one image registers — typically the first.
        for iid in self._candidate_ranking():
            X, uv, fp = self._visible_points(iid)
            if X.shape[0] < self.opt.abs_pose_min_num_inliers:
                continue
            n = X.shape[0]
            result = pnp.estimate_pose(
                X, uv, self.focal[iid], min_inliers=self.opt.abs_pose_min_num_inliers,
                device=self.device, samples=self.samples.pnp(n, pnp.bucket_size(n)),
            )
            if result is None:
                continue
            R, t, inliers = result
            self.R[iid] = R
            self.t[iid] = t
            self.reg_rank[iid] = len(self.registered)
            self.registered.append(iid)
            self.registered_mask[self.iid_index[iid]] = True
            # Attach inlier observations to their tracks.
            for k in np.nonzero(inliers)[0]:
                feat, pid = int(fp[k, 0]), int(fp[k, 1])
                if self.pid_of_g[self._gid(iid, feat)] >= 0 or not self._pid_live[pid]:
                    continue
                if self._track_has_image(pid, iid):
                    continue
                if self._reproj_err(iid, self.X[pid], feat) <= self.opt.max_reproj_error_px:
                    self._assign(iid, feat, pid)
            return iid
        return None

    # ------------------------------------------------------------------
    # Triangulation of new tracks
    # ------------------------------------------------------------------

    def _triangulate_new(self, iid: int) -> int:
        """Create points from matches between iid and registered images.

        Candidate collection, DLT, and gating are fully vectorized; only
        the final one-point-per-feature conflict resolution is sequential.
        """
        lo = self.base[iid]
        hi = lo + self.kp[iid].shape[0]
        lo_ptr, hi_ptr = self.corr_start[lo], self.corr_start[hi]
        if hi_ptr == lo_ptr:
            return 0
        nbr = self.corr_nbr[lo_ptr:hi_ptr]
        counts = np.diff(self.corr_start[lo : hi + 1])
        src = np.repeat(np.arange(lo, hi), counts)
        cand = (
            (self.pid_of_g[src] < 0)
            & (self.pid_of_g[nbr] < 0)
            & self.registered_mask[self.img_of_g[nbr]]
        )
        if not cand.any():
            return 0
        return self._triangulate_pairs(src[cand], nbr[cand])

    def _retriangulate(self) -> int:
        """Retry triangulation of still-unassigned features of every
        registered image (COLMAP's retriangulation pass after global BA —
        filtered/failed tracks get a second chance with better poses).

        One batched pass over ALL registered images: the per-image loop
        (100 sequential DLT dispatches at 100 cameras) was latency-bound
        on the device link (~35 ms per round trip), not compute."""
        # Candidate edges (src < nbr dedups the two directed copies each
        # correspondence has in the CSR arrays): both ends unassigned,
        # both images registered.
        reg_g = self.registered_mask[self.img_of_g]
        srcs = np.repeat(np.arange(self.total), np.diff(self.corr_start))
        nbrs = self.corr_nbr
        cand = (
            (srcs < nbrs)
            & (self.pid_of_g[srcs] < 0)
            & (self.pid_of_g[nbrs] < 0)
            & reg_g[srcs]
            & reg_g[nbrs]
        )
        src, nbr = srcs[cand], nbrs[cand]
        if src.size == 0:
            return 0
        # Chunked dispatches bound the padded DLT problem (and the host
        # staging arrays) regardless of scene size.
        CHUNK = 1 << 18
        total = 0
        for s in range(0, src.size, CHUNK):
            total += self._triangulate_pairs(src[s : s + CHUNK], nbr[s : s + CHUNK])
        return total

    def _triangulate_pairs(self, src: np.ndarray, nbr: np.ndarray) -> int:
        """Triangulate + gate + commit candidate (src gid, nbr gid) pairs
        with per-row cameras on both sides; returns points created."""
        n = src.size
        src_idx = self.img_of_g[src]
        nbr_idx = self.img_of_g[nbr]
        uniq = np.unique(np.concatenate([src_idx, nbr_idx]))
        Ro = np.stack([self.R[self.iids[k]] for k in uniq])
        to = np.stack([self.t[self.iids[k]] for k in uniq])
        ls = np.searchsorted(uniq, src_idx)
        ln = np.searchsorted(uniq, nbr_idx)
        focal_s = self.focal_g[src]
        focal_n = self.focal_g[nbr]

        P = np.zeros((n, 2, 3, 4))
        P[:, 0] = np.concatenate([Ro[ls], to[ls][:, :, None]], axis=2)
        P[:, 1] = np.concatenate([Ro[ln], to[ln][:, :, None]], axis=2)
        uv = np.stack([self.uv_g[src], self.uv_g[nbr]], axis=1)
        X = self._triangulate(P, uv)

        ok = np.isfinite(X).all(axis=1)
        c1 = np.einsum("nab,nb->na", Ro[ls], X) + to[ls]
        z1 = c1[:, 2]
        proj1 = c1[:, :2] / np.where(np.abs(z1[:, None]) < 1e-12, 1e-12, z1[:, None])
        e1 = np.linalg.norm(proj1 - self.uv_g[src], axis=1) * focal_s
        c2 = np.einsum("nab,nb->na", Ro[ln], X) + to[ln]
        z2 = c2[:, 2]
        proj2 = c2[:, :2] / np.where(np.abs(z2[:, None]) < 1e-12, 1e-12, z2[:, None])
        e2 = np.linalg.norm(proj2 - self.uv_g[nbr], axis=1) * focal_n
        ok &= (z1 > 0) & (z2 > 0)
        ok &= np.maximum(e1, e2) <= self.opt.max_reproj_error_px

        centers1 = -np.einsum("nba,nb->na", Ro[ls], to[ls])
        centers2 = -np.einsum("nba,nb->na", Ro[ln], to[ln])
        d1 = X - centers1
        d2 = X - centers2
        cosang = np.sum(d1 * d2, axis=1) / np.maximum(
            np.linalg.norm(d1, axis=1) * np.linalg.norm(d2, axis=1), 1e-12
        )
        ang = np.arccos(np.clip(cosang, -1, 1))
        ok &= ang >= np.deg2rad(self.opt.min_tri_angle_deg)

        new = 0
        for k in np.nonzero(ok)[0]:
            if self.pid_of_g[src[k]] >= 0 or self.pid_of_g[nbr[k]] >= 0:
                continue
            sid = self.iids[src_idx[k]]
            oid = self.iids[nbr_idx[k]]
            self._new_point(
                X[k],
                [
                    (sid, int(src[k] - self.base[sid])),
                    (oid, int(nbr[k] - self.base[oid])),
                ],
            )
            new += 1
        return new

    # ------------------------------------------------------------------
    # Bundle adjustment + filtering
    # ------------------------------------------------------------------

    def _collect_obs(self, cam_ids: List[int], pids: List[int]):
        """Observation arrays for BA over (cam_ids x pids), fully
        vectorized: one pass over the flat assignment array instead of a
        per-track Python loop (the loop was the global-BA bottleneck at
        100+ cameras)."""
        cam_index = {iid: k for k, iid in enumerate(cam_ids)}
        pt_index = {pid: k for k, pid in enumerate(pids)}
        # LUTs: image index -> camera slot, pid -> point slot (-1 = drop).
        cam_lut = np.full(len(self.iids), -1, np.int64)
        for iid, k in cam_index.items():
            cam_lut[self.iid_index[iid]] = k
        pid_lut = np.full(self.next_pid, -1, np.int64)
        pid_lut[np.asarray(pids, np.int64)] = np.arange(len(pids))

        gids = np.flatnonzero(self.pid_of_g >= 0)
        ocam = cam_lut[self.img_of_g[gids]]
        opt = pid_lut[self.pid_of_g[gids]]
        keep = (ocam >= 0) & (opt >= 0)
        gids, ocam, opt = gids[keep], ocam[keep], opt[keep]
        order = np.argsort(opt, kind="stable")
        gids = gids[order]
        return (
            ocam[order],
            opt[order],
            self.uv_g[gids],
            self.focal_g[gids],
            cam_index,
            pt_index,
        )

    def _run_ba(self, local_around: Optional[int] = None, final: bool = False) -> None:
        """Global BA, or local BA over ``local_around``'s neighborhood.

        Local mode (COLMAP's per-registration local BA): free the new
        camera plus its most covisible registered neighbors; cameras
        outside the neighborhood that observe the same points stay in the
        problem with frozen poses, so their residuals still constrain the
        shared structure.
        """
        if len(self.registered) < 2 or self.n_points == 0:
            return

        if local_around is None:
            cam_ids = list(self.registered)
            pids = np.flatnonzero(self._pid_live[: self.next_pid]).tolist()
            free_set = set(cam_ids)
            iterations = self.opt.ba_iterations
        else:
            # Points seen by the new camera; covisibility-ranked neighbors
            # (one vectorized pass over the flat assignment array — the
            # per-track Python loop here was O(track obs) per
            # registration).
            seg = self.pid_of_g[
                self.base[local_around] : self.base[local_around]
                + self.kp[local_around].shape[0]
            ]
            cand = seg[seg >= 0]
            pids_arr = np.unique(cand[self._pid_live[cand]])
            if pids_arr.size == 0:
                return
            pids = pids_arr.tolist()
            gids_all = np.flatnonzero(self.pid_of_g >= 0)
            sel = np.isin(self.pid_of_g[gids_all], pids_arr)
            covis_cnt = np.bincount(
                self.img_of_g[gids_all[sel]], minlength=len(self.iids)
            )
            involved_idx = np.flatnonzero(covis_cnt > 0)
            local_idx = self.iid_index[local_around]
            nb = covis_cnt.copy()
            nb[local_idx] = 0
            k = min(self.opt.local_ba_neighbors, int((nb > 0).sum()))
            neighbor_idx = np.argpartition(-nb, k - 1)[:k] if k else np.zeros(0, int)
            free_set = {self.iids[i] for i in neighbor_idx if nb[i] > 0}
            free_set.add(local_around)
            cam_ids = sorted(
                (self.iids[i] for i in involved_idx), key=self.reg_rank.get
            )
            iterations = self.opt.ba_local_iterations

        obs_cam, obs_pt, obs_uv, obs_f, cam_index, pt_index = self._collect_obs(
            cam_ids, pids
        )
        if obs_cam.size == 0:
            return

        # Gauge fixing: in global mode freeze camera 0 + one translation
        # axis of camera 1; in local mode the frozen non-neighborhood
        # cameras (there is always at least one early camera) fix the
        # gauge, falling back to the global rule if everything is free.
        fixed = np.zeros((len(cam_ids), 6), bool)
        frozen = [i for i in cam_ids if i not in free_set]
        if frozen:
            for iid in frozen:
                fixed[cam_index[iid], :] = True
        if len(frozen) < 1 or local_around is None:
            anchor = cam_index.get(self.registered[0])
            if anchor is not None:
                fixed[anchor, :] = True
            if len(self.registered) > 1:
                second = cam_index.get(self.registered[1])
                if second is not None:
                    axis = int(np.argmax(np.abs(self.t[self.registered[1]])))
                    fixed[second, 3 + axis] = True

        problem = ba_mod.BAProblem(
            np.stack([self.R[i] for i in cam_ids]),
            np.stack([self.t[i] for i in cam_ids]),
            self.X[np.asarray(pids, np.int64)],
            obs_cam,
            obs_pt,
            obs_uv,
            obs_f,
            fixed,
            refine_focal=self.opt.refine_focal and local_around is None,
            # Views of the same physical camera share ONE focal parameter
            # (COLMAP's shared-intrinsics coupling).
            focal_group=np.asarray([self.image_cam[i] for i in cam_ids]),
        )
        R, t, fscale, X, _ = ba_mod.run_ba(
            problem,
            iterations=iterations,
            tol=1e-6 if final else self.opt.ba_intermediate_tol,
            device=self.device,
        )
        for iid, k in cam_index.items():
            if iid not in free_set:
                continue
            self.R[iid] = R[k]
            self.t[iid] = t[k]
            if problem.refine_focal and fscale[k] != 0.0:
                # Fold the refined focal into this view's observations so
                # later rounds (and _reproj_err) stay consistent: with
                # f1 = f0*exp(s), norm_uv_new = norm_uv * f0/f1.
                ratio = float(np.exp(fscale[k]))
                self.focal[iid] *= ratio
                self.norm_uv[iid] = self.norm_uv[iid] / ratio
                b = self.base[iid]
                n_i = self.kp[iid].shape[0]
                self.uv_g[b : b + n_i] = self.norm_uv[iid]
                self.focal_g[b : b + n_i] = self.focal[iid]
        # pt_index maps pids[k] -> k, so X rows are ordered like pids.
        self.X[np.asarray(pids, np.int64)] = X

    def _complete_tracks(self) -> int:
        """Attach unassigned features of registered images to existing
        points they match (COLMAP's track-completion role).  Vote
        collection and the reprojection gate are vectorized."""
        added = 0
        for iid in self.registered:
            lo = self.base[iid]
            hi = lo + self.kp[iid].shape[0]
            f, p, _ = self._vote_pids(lo, hi)
            if f.size == 0:
                continue
            live = self._pid_live[p]
            f, p = f[live], p[live]
            if f.size == 0:
                continue
            errs = self._reproj_err_batch(f, self.X[p])
            good = errs <= self.opt.max_reproj_error_px
            for gid, pid in zip(f[good], p[good]):
                if self.pid_of_g[gid] >= 0 or self._track_has_image(int(pid), iid):
                    continue
                self._assign(iid, int(gid - lo), int(pid))
                added += 1
        return added

    def _filter_points(self) -> int:
        """Drop high-error observations and short tracks — one vectorized
        pass over the flat assignment array (the per-track dict/list loop
        here was a superlinear term at 100+ cameras)."""
        if self.n_points == 0:
            return 0
        gids = np.flatnonzero(self.pid_of_g >= 0)
        if gids.size == 0:
            return 0
        pids = self.pid_of_g[gids]
        errs = self._reproj_err_batch(gids, self.X[pids])
        bad = errs > self.opt.max_reproj_error_px
        self._unassign_batch(gids[bad])
        # Tracks that fell below the minimum length lose their remaining
        # observations and die.
        short = np.flatnonzero(
            self._pid_live
            & (self.track_len < self.opt.min_track_len)
        )
        if short.size:
            keep = ~bad
            drop = keep & np.isin(pids, short)
            self._unassign_batch(gids[drop])
            self._pid_live[short] = False
            self.track_len[short] = 0
            self.n_points -= short.size
        return int(short.size)

    # ------------------------------------------------------------------

    def reconstruct(self, verbose: bool = True) -> Optional[model_mod.Model]:
        # Initialization: decreasing inlier count, but NON-PLANAR pairs
        # first — verification classifies low-parallax / planar pairs as
        # CONFIG_PLANAR_OR_PANORAMIC (sfm/verify.py's COLMAP-style H/F
        # test), and on dense rigs (100-camera arcs) the match-count
        # ranking alone is dominated by hundreds of near-adjacent pairs
        # whose baseline can never pass the triangulation-angle gate.
        n_allowed = int(self.allowed_mask.sum())
        ranked = sorted(
            (
                kv
                for kv in self.pair_matches.items()
                if self.allowed_mask[self.iid_index[kv[0][0]]]
                and self.allowed_mask[self.iid_index[kv[0][1]]]
            ),
            key=lambda kv: -kv[1].shape[0],
        )
        nonplanar, planar = [], []
        for kv in ranked:
            if self.pair_config.get(kv[0]) == verify.CONFIG_PLANAR_OR_PANORAMIC:
                planar.append(kv)
            else:
                nonplanar.append(kv)
        # Stratified candidate order: the top of the match-count ranking,
        # plus picks spread across the WHOLE ranking — on dense rigs the
        # top is saturated by near-adjacent (small-baseline) pairs that
        # can never pass the triangulation-angle gate, while wide-baseline
        # pairs (fewer matches) live far down the list.
        idx = list(range(min(12, len(nonplanar))))
        if len(nonplanar) > 12:
            stride = max(1, len(nonplanar) // 48)
            idx += list(range(0, len(nonplanar), stride))[:48]
        candidates = [nonplanar[i] for i in sorted(set(idx))] + planar[:10]

        first_iid = None
        initialized = False
        for (id1, id2), _ in candidates:
            with self.phases.span("init"):
                ok = self._try_initialize(id1, id2)
                if not ok:
                    continue
                self._run_ba()
                self._filter_points()
                # An init pair whose structure cannot register ANY third
                # image is a dead end (narrow baseline / bas-relief skew):
                # discard and try the next candidate (colmap retries init
                # the same way).
                first_iid = self._register_next()
                if first_iid is None and n_allowed > 2:
                    self._reset_reconstruction()
                    continue
            initialized = True
            if verbose:
                print(
                    f"[mapper] initialized with ({self.image_info[id1]}, "
                    f"{self.image_info[id2]}), {self.n_points} points"
                )
            break
        if not initialized:
            return None

        def _global_round():
            with self.phases.span("global_ba"):
                self._run_ba()
            with self.phases.span("filter_points"):
                self._filter_points()
            with self.phases.span("retriangulate"):
                self._retriangulate()
            with self.phases.span("complete_tracks"):
                self._complete_tracks()

        def _next_global_at(n_reg: int) -> int:
            if self.opt.ba_global_every is not None:
                return n_reg + self.opt.ba_global_every
            return max(int(np.ceil(self.opt.ba_global_ratio * n_reg)), n_reg + 1)

        next_global = _next_global_at(len(self.registered))
        pending_first = first_iid
        retried_after_stall = False
        while True:
            if pending_first is not None:
                iid, pending_first = pending_first, None
            else:
                with self.phases.span("pnp_register"):
                    iid = self._register_next()
            if iid is None:
                # Registration stall: before giving up, run the global
                # bookkeeping round (BA + filtering + retriangulation +
                # track completion) and retry ONCE — mid-run structure
                # near the frontier is often too drifted/contaminated for
                # PnP until it is re-optimized (colmap mapper retries
                # registration the same way; measured: a 100-camera
                # refined run stalled at 49/100 without this, while the
                # post-run bookkeeping made every remaining image
                # registerable).
                if retried_after_stall or len(self.registered) >= n_allowed:
                    break
                _global_round()
                next_global = _next_global_at(len(self.registered))
                retried_after_stall = True
                continue
            retried_after_stall = False
            with self.phases.span("triangulate"):
                n_new = self._triangulate_new(iid)
            # Local BA around every newly registered camera (colmap
            # mapper behavior; keeps drift bounded between global rounds).
            with self.phases.span("local_ba"):
                self._run_ba(local_around=iid)
            if len(self.registered) >= next_global:
                _global_round()
                next_global = _next_global_at(len(self.registered))
            if verbose:
                print(
                    f"[mapper] registered {self.image_info[iid]} "
                    f"({len(self.registered)}/{n_allowed}), +{n_new} points"
                )
        with self.phases.span("retriangulate"):
            self._retriangulate()
        with self.phases.span("complete_tracks"):
            self._complete_tracks()
        with self.phases.span("global_ba"):
            self._run_ba(final=True)
        with self.phases.span("filter_points"):
            self._filter_points()

        with self.phases.span("to_model"):
            return self._to_model()

    def _to_model(self) -> model_mod.Model:
        model = model_mod.Model()
        for cid, cam in self.cameras.items():
            model.cameras[cid] = model_mod.Camera(
                cid,
                db_mod.CAMERA_MODEL_NAMES[cam["model"]],
                cam["width"],
                cam["height"],
                cam["params"],
            )
        for iid in self.registered:
            kp = self.kp[iid]
            xys = kp[:, :2].astype(np.float64) if kp.shape[0] else np.zeros((0, 2))
            b = self.base[iid]
            pids = self.pid_of_g[b : b + xys.shape[0]].copy()
            live = (pids >= 0) & self._pid_live[np.maximum(pids, 0)]
            pids[~live] = -1
            model.images[iid] = model_mod.Image(
                iid,
                model_mod.rotmat_to_qvec(self.R[iid]),
                self.t[iid],
                self.image_cam[iid],
                self.image_info[iid],
                xys,
                pids,
            )
        # Tracks + per-point mean reprojection error, recovered from the
        # flat assignment array by one sort/group pass (no per-track
        # Python state).
        gids = np.flatnonzero(self.pid_of_g >= 0)
        if gids.size == 0:
            return model
        pids_arr = self.pid_of_g[gids]
        errs = self._reproj_err_batch(gids, self.X[pids_arr])
        sums = np.bincount(
            pids_arr, weights=np.nan_to_num(errs, posinf=0.0), minlength=self.next_pid
        )
        cnts = np.bincount(pids_arr, minlength=self.next_pid)
        order = np.argsort(pids_arr, kind="stable")
        g_sorted = gids[order]
        p_sorted = pids_arr[order]
        track_iids = np.asarray(self.iids)[self.img_of_g[g_sorted]]
        # Feature index = gid - base[owner image], vectorized via a per-
        # image base lookup.
        base_arr = np.asarray([self.base[i] for i in self.iids])
        track_feats = g_sorted - base_arr[self.img_of_g[g_sorted]]
        starts = np.searchsorted(p_sorted, np.arange(self.next_pid))
        ends = np.searchsorted(p_sorted, np.arange(self.next_pid), side="right")
        for pid in np.flatnonzero(self._pid_live[: self.next_pid]).tolist():
            lo, hi = starts[pid], ends[pid]
            model.points3D[pid] = model_mod.Point3D(
                pid,
                self.X[pid].copy(),
                np.full(3, 128, np.uint8),
                float(sums[pid] / cnts[pid]) if cnts[pid] else 0.0,
                track_iids[lo:hi].copy(),
                track_feats[lo:hi].copy(),
            )
        return model


def reconstruct(
    database: db_mod.ColmapDatabase,
    options: MapperOptions = None,
    verbose: bool = True,
    device="cuda",
    samples=None,
) -> Tuple[Optional[model_mod.Model], dict]:
    """Run incremental SfM; returns (model, analyzer stats).

    A disconnected match graph yields several models: after registration
    exhausts, the mapper re-seeds on the unregistered remainder, and the
    LARGEST model by camera count is returned (the reference keeps every
    model colmap produces and selects the largest,
    colmap_utils.py:238-264).  The stats record how many models were
    built and their sizes so callers can report which one was selected.
    """
    mapper = IncrementalMapper(database, options, device=device, samples=samples)
    opt = mapper.opt
    models = []
    while len(models) < opt.max_models and int(mapper.allowed_mask.sum()) >= 2:
        model = mapper.reconstruct(verbose=verbose)
        if model is None:
            break
        if models and len(model.images) < opt.min_model_size:
            break
        models.append(model)
        for iid in mapper.registered:
            mapper.allowed_mask[mapper.iid_index[iid]] = False
        mapper._reset_reconstruction()
    if not models:
        return None, {}
    sizes = [len(m.images) for m in models]
    best_k = int(np.argmax(sizes))
    best = models[best_k]
    if verbose and len(models) > 1:
        print(
            f"[mapper] {len(models)} disconnected models of sizes {sizes}; "
            f"selected model {best_k} with {sizes[best_k]} images"
        )
    stats = analyze_model(best)
    stats["num_models"] = len(models)
    stats["model_sizes"] = sizes
    stats["selected_model"] = best_k
    # Where the reconstruction wall-clock went (accumulated across all
    # models of this sweep) — the scale-run deliverable.
    stats["phase_times"] = mapper.phases.report()
    if verbose:
        print(f"[mapper] phase breakdown: {stats['phase_times']}")
    return best, stats
