"""Loop closure: BoW retrieval, geometric verification, pose graph.

Counterpart of ``gslam_tpu/models/loop_closure.py``: every keyframe's
descriptors become a sparse BoW vector in a keyframe database; a new
keyframe queries it, candidates are verified geometrically (word-gated
descriptor matching, then search by projection, each with a PnP RANSAC),
the verified loop's observations are fused into the map, a pose graph
over the temporal chain, strong covisibility pairs and the loop edge is
optimized, map points are carried rigidly with their reference keyframe,
and a short global BA polishes the map when the correction moved it.

The database lives on the device: (cap_frames, S) word-id and weight
slabs, S * 8 bytes per keyframe at any vocabulary size; a query is one
scatter and one gather (``score_l1_sparse``) and its scores are read
back once per detection.  Verification and correction read a handful of
scalars per keyframe (counts, the map extent, the covisibility matrix
for edge selection): once per keyframe, not per frame.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from gslam_tpu_torch.core.se3 import se3_apply, se3_inverse, se3_mul
from gslam_tpu_torch.estimation.pnp import find_pnp_ransac, pose_information
from gslam_tpu_torch.map.arena import (
    MapArena, add_observations, covis_union_ids, covisibility_matrix,
    covisibility_row,
)
from gslam_tpu_torch.ops.matching import (
    match_descriptors, match_descriptors_gated, match_descriptors_word_gated,
)
from gslam_tpu_torch.ops.vocab import (
    SparseBow, Vocabulary, score_l1_sparse, transform_sparse, transform_words,
)
from gslam_tpu_torch.opt.ba import frame_obs_slabs, global_bundle_adjust
from gslam_tpu_torch.opt.pose_graph import PoseGraph, optimize_pose_graph
from gslam_tpu_torch.utils.timer import Timer

_IDENT7 = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)


def map_volume(arena: MapArena, n_frames: int):
    """(lo, hi, margin) of the keyframe centres' bounding box grown by
    1 m, as numpy: a revisiting or relocalized camera must lie within
    ``margin`` of it."""
    fpos = se3_inverse(arena.frame_pose[:n_frames, :7])[:, :3].cpu().numpy()
    lo, hi = fpos.min(0) - 1.0, fpos.max(0) + 1.0
    return lo, hi, 0.5 * float((hi - lo).max()) + 1.0


def inside_volume(center: np.ndarray, lo, hi, margin: float) -> bool:
    return bool(np.isfinite(center).all()
                and not (center < lo - margin).any()
                and not (center > hi + margin).any())


class LoopCloser:
    """Keyframe database + loop detection / correction.

    Detection thresholds self-calibrate: a candidate must score at least
    ``rel_factor`` times the query's score against its own previous
    keyframe (the same-scene reference), with ``min_score`` as an
    absolute floor.  RANSAC draws come from a ``torch.Generator`` on the
    vocabulary's device seeded with ``seed``, or, when ``uniforms`` is
    given, from ``uniforms()``, a callable returning the (ransac_B, 4)
    uniforms of each draw (the tests replay the JAX package's key chain
    through it).  ``use_kernels`` routes the tree descent through the B7
    kernel and the post-loop global BA through B5 / B6 where their
    contracts allow.
    """

    def __init__(self, voc: Vocabulary, cap_frames: int,
                 min_score: float = 0.015, min_gap: int = 10,
                 min_inliers: int = 20, seed: int = 1,
                 use_kernels: bool = True, rel_factor: float = 0.5,
                 ransac_B: int = 1024,
                 uniforms: Optional[Callable[[], torch.Tensor]] = None,
                 timer: Optional[Timer] = None):
        self.voc = voc
        self.device = voc.device
        self.use_kernels = use_kernels
        self.min_score = min_score
        self.rel_factor = rel_factor
        self.min_gap = min_gap
        self.min_inliers = min_inliers
        self.frac_bar = 0.3      # see _verify_bar
        # loop matches carry no pose prior, so their inlier rate is far
        # below the tracker's gated matches: a deeper hypothesis pool
        self.ransac_B = ransac_B
        # essential-graph edge selection (see close())
        self.max_covis_edges = 3
        self.covis_min_common = 20
        self.covis_max_span = 12   # KFs: rigidity edges only over
        #                            locally-validated spans
        S = 512  # sparse slots per keyframe (>= distinct words / frame)
        self._slots = S
        self.bow_words = torch.full((cap_frames, S), -1, dtype=torch.int32,
                                    device=self.device)
        self.bow_weights = torch.zeros((cap_frames, S), device=self.device)
        self.n_kf = 0
        self._uniforms = uniforms
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.timer = timer if timer is not None else Timer()
        self.closed: List[Tuple[int, int]] = []
        # post-closure cooldown: right after a correction the map is
        # consistent; re-closing the same revisit at once would run the
        # pose graph and global BA against their own correction noise
        self.cooldown = 8
        self._last_closed_kf = -10**9
        # per-verification log: (kf, cand, n_inliers, n_matches, accepted)
        self.verify_log: List[Tuple[int, int, int, int, bool]] = []

    def _verify_bar(self, n_matches: int) -> int:
        """Verification inlier bar for a candidate with ``n_matches``
        matches: an absolute floor (``min_inliers``: PnP consensus below
        about a dozen points is noise at any scale) and a fraction of the
        achievable matches (repetitive texture aliases descriptor RANSAC
        to a consensus that grows with the match count, genuine revisits
        verify at a far higher fraction; the fraction is scale-free)."""
        return max(self.min_inliers, int(self.frac_bar * n_matches))

    def _find_pnp(self, xyz, rays, valid, thr, max_depth):
        draw = dict(generator=self._gen) if self._uniforms is None \
            else dict(uniforms=self._uniforms())
        return find_pnp_ransac(xyz, rays, valid, threshold=thr,
                               max_depth=max_depth, B=self.ransac_B, **draw)

    def add_keyframe(self, kf_id: int, desc: torch.Tensor,
                     valid: torch.Tensor) -> None:
        """Store keyframe ``kf_id``'s sparse BoW vector.  The slab binds
        only when a frame carries more distinct words than slots; it
        then keeps the S heaviest words, L1-normalized again, in word
        order (on the host, as the JAX package does)."""
        bow, _ = transform_sparse(self.voc, desc, valid,
                                  use_kernels=self.use_kernels)
        S = self._slots
        words, weights = bow.words, bow.weights
        n = min(S, words.shape[0])
        if words.shape[0] > S and int((words >= 0).sum()) > S:
            w_np, wt_np = words.cpu().numpy(), weights.cpu().numpy()
            order = np.argsort(-wt_np)[:S]
            w_np, wt_np = w_np[order], wt_np[order]
            wt_np = wt_np / max(float(wt_np.sum()), 1e-12)
            o2 = np.argsort(w_np)
            words = torch.from_numpy(w_np[o2]).to(self.device)
            weights = torch.from_numpy(wt_np[o2]).to(self.device)
        self.bow_words[kf_id, :n] = words[:n]
        self.bow_weights[kf_id, :n] = weights[:n]
        self.n_kf = max(self.n_kf, kf_id + 1)

    def query(self, bow: SparseBow, n: Optional[int] = None) -> np.ndarray:
        """L1 scores of a SparseBow against the first ``n`` keyframes,
        on the host (one read)."""
        n = self.n_kf if n is None else n
        if n == 0:
            return np.zeros(0, np.float32)
        return score_l1_sparse(bow, self.bow_words[:n], self.bow_weights[:n],
                               self.voc.n_words).cpu().numpy()

    def bow_of(self, kf_id: int) -> SparseBow:
        return SparseBow(self.bow_words[kf_id], self.bow_weights[kf_id])

    def detect(self, kf_id: int, top_k: int = 3, covis_row=None) -> list:
        """Loop candidates for ``kf_id``, best first (possibly empty).

        ``covis_row``: optional (F,) shared-landmark counts of kf_id
        against every keyframe.  Covisibility-connected keyframes see the
        current scene by map continuity, not by revisit, and are
        excluded; ``min_gap`` stays as a small temporal guard."""
        if self.n_kf <= self.min_gap:
            return []
        scores = self.query(self.bow_of(kf_id))
        # the previous keyframe sees the same scene, so its score is the
        # "genuine revisit" reference
        ref = scores[kf_id - 1] if kf_id >= 1 else 1.0
        thr = max(self.min_score, self.rel_factor * float(ref))
        lo = max(0, kf_id - self.min_gap)
        scores[lo:] = -1.0                  # temporally-near keyframes
        if covis_row is not None:
            if torch.is_tensor(covis_row):
                covis_row = covis_row.cpu().numpy()
            row = np.asarray(covis_row)[:scores.shape[0]]
            scores[row >= self.covis_min_common] = -1.0
        order = np.argsort(-scores)[:top_k]
        return [int(i) for i in order if scores[i] >= thr]

    def verify(self, arena: MapArena, camera, kf_id: int, cand_id: int,
               max_points: int = 512
               ) -> Optional[Tuple[torch.Tensor, int]]:
        """Geometric check: the current keyframe's features against the
        candidate's landmarks.  Returns (T_cw of ``kf_id`` in the
        candidate's (= world) frame, n_inliers) or None."""
        dev = arena.device
        # the candidate's landmarks enriched by its covisibility
        # neighbourhood (map hygiene thins per-frame observation lists)
        pids = covis_union_ids(
            arena, torch.full((), cand_id, dtype=torch.int32, device=dev),
            max_points, window=4, min_common=5)
        pslot = pids.clamp_min(0).long()
        ok = (pids >= 0) & arena.point_valid[pslot]
        xyz = arena.point_xyz[pslot]
        pdesc = arena.point_desc[pslot]
        fdesc = arena.frame_desc[kf_id]
        kp_uv = arena.frame_kp_uv[kf_id]
        fvalid = torch.arange(fdesc.shape[0], device=dev) \
            < arena.frame_kp_count[kf_id]
        # word-gated matching: pairs gated to the same vocabulary node
        # two levels above the leaves
        if self.voc.L >= 2:
            wa = transform_words(self.voc, pdesc, ok,
                                 use_kernels=self.use_kernels)
            wb = transform_words(self.voc, fdesc, fvalid,
                                 use_kernels=self.use_kernels)
            m = match_descriptors_word_gated(
                pdesc, ok, wa, fdesc, fvalid, wb, ratio=0.9,
                level_div=self.voc.k ** 2)
        else:
            m = match_descriptors(pdesc, ok, fdesc, fvalid, ratio=0.9)
        rays = camera.unproject(kp_uv[m.idx.clamp_min(0).long()])[:, :2]
        thr = (2.0 / camera.fx) ** 2
        # a scene-scale depth bound starves degenerate RANSAC hypotheses
        # (a camera absurdly far away with distant points projecting
        # tightly)
        big = torch.full_like(xyz, float("inf"))
        span = (torch.where(ok[:, None], xyz, -big).amax(0)
                - torch.where(ok[:, None], xyz, big).amin(0)).amax()
        extent = float(span) if bool(ok.any()) else 1.0
        max_depth = 4.0 * extent + 10.0
        T, inl, n = self._find_pnp(xyz, rays, m.valid, thr, max_depth)
        n_first = int(n)
        if n_first < max(4, self.min_inliers // 3):
            self.verify_log.append((kf_id, cand_id, n_first, int(m.count),
                                    False))
            return None
        # second stage: re-match by projecting the slab under the coarse
        # pose with a generous pixel gate, then re-solve
        uv_pred, proj_ok = camera.project(se3_apply(T, xyz))
        m2 = match_descriptors_gated(
            pdesc, ok & proj_ok, fdesc, fvalid, uv_pred, kp_uv,
            gate_radius=0.25 * camera.width, max_dist=64.0, ratio=0.9)
        rays2 = camera.unproject(kp_uv[m2.idx.clamp_min(0).long()])[:, :2]
        T2, inl2, n2 = self._find_pnp(xyz, rays2, m2.valid, thr, max_depth)
        n_i = n_first
        if int(n2) > n_first:
            T, n_i, m, inl = T2, int(n2), m2, inl2
        n_m = int(m.count)
        accepted = n_i >= self._verify_bar(n_m)
        self.verify_log.append((kf_id, cand_id, n_i, n_m, accepted))
        if not accepted:
            return None
        self._last_verify = (pids, m.idx, m.valid & inl)
        # estimator-derived information of the verified loop pose: the GN
        # Hessian over the inlier reprojections, in the units of the
        # per-keyframe pose information of close()
        rays_fin = camera.unproject(kp_uv[m.idx.clamp_min(0).long()])[:, :2]
        self._last_loop_H = pose_information(
            T, torch.cat([xyz, rays_fin], -1),
            (m.valid & inl).to(torch.float32)).cpu().numpy()
        # physical plausibility: a revisiting camera lies within the
        # (expanded) map volume; a degenerate consensus set can pass the
        # inlier count with an absurd pose
        center = se3_inverse(T)[:3].cpu().numpy()
        if not inside_volume(center, *map_volume(arena,
                                                 int(arena.n_frames))):
            return None
        return T, n_i

    def close(self, arena: MapArena, camera, kf_id: int,
              imu_edges=None, global_ba_iters: int = 0
              ) -> Tuple[MapArena, bool]:
        """Detect + verify + fuse + pose-graph correct (+ global BA).
        Returns (arena, did).

        The verified loop matches are fused into the map as observations
        of the candidate's landmarks by the current keyframe: without
        them a later bundle adjustment would relax the map back to the
        drifted configuration.  After the pose-graph correction a short
        global BA (``global_ba_iters`` > 0) polishes the whole map
        through those observations, when the correction moved the map.
        """
        if imu_edges:
            raise NotImplementedError(
                "IMU rotation edges in the loop pose graph are not ported "
                "to gslam_tpu_torch yet (ROADMAP Queue A item 13)")
        if kf_id - self._last_closed_kf < self.cooldown:
            return arena, False
        dev = arena.device
        ver = None
        cand = None
        covis_kf = covisibility_row(arena, kf_id)
        for cand in self.detect(kf_id, covis_row=covis_kf):
            ver = self.verify(arena, camera, kf_id, cand)
            if ver is not None:
                break
        if ver is None:
            return arena, False
        T_loop_cw, _ = ver      # the pose of kf_id implied by the loop
        v_pids, v_kp, v_ok = self._last_verify
        arena = add_observations(arena, kf_id,
                                 torch.where(v_ok, v_pids, -1),
                                 v_kp.clamp_min(0), v_ok)

        F = int(arena.n_frames)
        poses_cw = arena.frame_pose[:F, :7]
        # estimator-derived edge information: each keyframe's 6-dof pose
        # information is the GN Hessian of its own reprojections against
        # the (fixed) landmarks; an edge carries the elementwise harmonic
        # combination of its endpoints' informations, normalized by the
        # median odometry diagonal so that odometry edges stay near unit
        # scale while the relative weighting is measured
        data_f, wgt_f = frame_obs_slabs(arena, camera)
        H_kf = pose_information(arena.frame_pose[:, :7], data_f,
                                wgt_f).cpu().numpy()[:F]
        diag = np.einsum("fii->fi", H_kf)                     # (F, 6)
        # a hygiene-culled keyframe has an exactly-zero Hessian; it gets
        # unit-scale information instead, so it is carried rigidly with
        # the chain and not left behind at its drifted pose
        degenerate = diag.max(axis=1) < 1e-6
        d_kf = np.maximum(diag, 1e-6)
        frame_valid = arena.frame_valid[:F].cpu().numpy()
        scale = np.median(d_kf[frame_valid & ~degenerate]) \
            if F and (~degenerate).any() else 1.0
        d_kf = d_kf / max(scale, 1e-9)
        d_kf[degenerate] = 1.0

        # odometry edges between consecutive keyframes
        ei = list(range(1, F))
        ej = list(range(0, F - 1))
        # essential-graph edges: non-consecutive keyframe pairs with
        # strong view overlap, within a locally-validated span (a
        # long-range rigidity edge measured from the still-drifted
        # estimate would lock in the error the loop edge removes)
        cov = covisibility_matrix(arena).cpu().numpy()[:F, :F]
        for i in range(2, F):
            row = cov[i, :i - 1].copy()           # strictly non-adjacent
            row[:max(0, i - self.covis_max_span)] = 0
            for j in np.argsort(-row)[:self.max_covis_edges]:
                if row[j] < self.covis_min_common:
                    break
                ei.append(i)
                ej.append(int(j))
        ei_a = np.asarray(ei, np.int64)
        ej_a = np.asarray(ej, np.int64)
        rel = se3_mul(poses_cw[torch.from_numpy(ei_a).to(dev)],
                      se3_inverse(poses_cw[torch.from_numpy(ej_a).to(dev)]))
        w = (1.0 / (1.0 / d_kf[ei_a] + 1.0 / d_kf[ej_a]) * 2.0).astype(
            np.float32)
        # loop edge: the measured relative pose kf_id <- cand, weighted by
        # the verification PnP's GN Hessian (same units and divisor),
        # clipped to a sane band: a marginal closure pulls gently
        Z = se3_mul(T_loop_cw, se3_inverse(poses_cw[cand]))
        ei.append(kf_id)
        ej.append(cand)
        rel = torch.cat([rel, Z[None]]).cpu().numpy()
        d_loop = np.maximum(np.diag(self._last_loop_H), 1e-6) \
            / max(scale, 1e-9)
        w = np.concatenate([w, np.clip(d_loop, 0.25, 8.0).astype(
            np.float32)[None]])

        # nodes and edges padded to bucket sizes (fixed identities, zero-
        # weight edges), as the JAX package pads them: the dense solve's
        # size and the auto solver's choice follow the bucket
        E_real = len(ei)
        Np = max(64, 1 << (F - 1).bit_length())
        Ep = max(256, 1 << (E_real - 1).bit_length())
        poses_p = np.tile(_IDENT7, (Np, 1))
        poses_p[:F] = poses_cw.cpu().numpy()
        fixed_p = np.ones(Np, bool)
        fixed_p[1:F] = False
        ei_p = np.zeros(Ep, np.int32)
        ej_p = np.zeros(Ep, np.int32)
        ei_p[:E_real] = ei
        ej_p[:E_real] = ej
        rel_p = np.tile(_IDENT7, (Ep, 1))
        rel_p[:E_real] = rel
        w_p = np.zeros((Ep, 6), np.float32)
        w_p[:E_real] = w
        valid_p = np.zeros(Ep, bool)
        valid_p[:E_real] = True
        g = PoseGraph(*(torch.from_numpy(a).to(dev) for a in (
            poses_p, fixed_p, ei_p, ej_p, rel_p, valid_p, w_p)))
        out, _ = optimize_pose_graph(g, iters=15)

        # write the corrected poses; carry each point rigidly with its
        # reference keyframe: X' = T_ref'^-1 T_ref X (camera coordinates
        # preserved)
        old = poses_cw
        new = out.poses[:F]
        ref = arena.point_ref_frame.clamp(0, F - 1).long()
        X_cam = se3_apply(old[ref], arena.point_xyz)
        X_new = se3_apply(se3_inverse(new)[ref], X_cam)
        fp = arena.frame_pose.clone()
        fp[:F, :7] = new
        arena = arena.replace(
            frame_pose=fp,
            point_xyz=torch.where(arena.point_valid[:, None], X_new,
                                  arena.point_xyz))
        # the global BA runs only when the correction moved the map: the
        # largest keyframe-centre shift against 1% of the scene extent
        # (5 cm floor)
        run_gba = global_ba_iters > 0
        if run_gba:
            ctr = torch.stack([se3_inverse(old)[:, :3],
                               se3_inverse(new)[:, :3]]).cpu().numpy()
            max_shift = float(np.linalg.norm(ctr[1] - ctr[0], axis=1).max())
            extent = float(np.ptp(ctr[1], axis=0).max())
            run_gba = max_shift >= max(0.05, 0.01 * extent)
        if run_gba:
            with self.timer.section("slam/loop_gba"):
                arena, _ = global_bundle_adjust(
                    arena, camera, iters=global_ba_iters, sweeps=1,
                    use_kernels=self.use_kernels)
                self.timer.block(arena.frame_pose)
        self.closed.append((kf_id, cand))
        self._last_closed_kf = kf_id
        return arena, True
