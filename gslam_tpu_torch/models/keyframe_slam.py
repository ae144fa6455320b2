"""Keyframe SLAM, RGB-D sequential path: track against the local map,
keyframe mapping, local bundle adjustment, loop closure, relocalization,
map hygiene.

Counterpart of ``gslam_tpu/models/keyframe_slam.py`` for frames that
carry depth, one frame per ``track`` call:

  track:    extract (FAST + NMS (B1), BRIEF (B2)) -> covisibility slab ->
            projection under the constant-velocity prediction -> gated
            Hamming matching (B4) -> PnP RANSAC + GN refine
  keyframe: promotion decided on the host from the frame's one packed
            fetch (match count, inlier count, pose jump, feature count);
            frame insert, fuse of tracked observations, new points from
            depth away from existing ones
  local BA: covisibility window -> Schur LM (B5 normal equations, B6
            cost) -> write-back
  loop:     with a vocabulary, every keyframe goes into the BoW
            database (tree descent, B7); loops are detected, verified,
            fused and corrected by the pose graph and a gated global BA
            (:mod:`gslam_tpu_torch.models.loop_closure`); a lost tracker
            relocalizes through the database
  hygiene:  found-ratio cull every keyframe; descriptor / normal refresh,
            redundant-keyframe erase and compaction at the hygiene
            interval.

The map lives on the device in a :class:`~gslam_tpu_torch.map.arena.
MapArena`; frame and keyframe decisions read host mirrors of its
counters, so a tracked frame costs one device fetch.  Not ported yet,
and raising ``NotImplementedError`` rather than skipped: frames without
depth (the monocular two-view bootstrap and triangulation), frames with
IMU samples, ``n_levels > 1`` and ``dispatch_batch > 1`` (ROADMAP Queue
A items 9, 13, 3 and 12).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.se3 import se3_apply, se3_inverse, se3_mul
from gslam_tpu_torch.core.sim3 import sim3_from_se3
from gslam_tpu_torch.datasets.base import FrameData
from gslam_tpu_torch.estimation.pnp import find_pnp_ransac
from gslam_tpu_torch.map.arena import (
    INT32_MAX, MapArena, add_observations, compact_arena, covis_union_ids,
    covisibility_topk, cull_by_found_ratio, erase_frame, insert_frame,
    insert_points, load_arena, make_arena, redundant_frames, refresh_points,
    set_rows,
)
from gslam_tpu_torch.models.loop_closure import (
    LoopCloser, inside_volume, map_volume,
)
from gslam_tpu_torch.ops.cuda.matcher import match_hamming_gated
from gslam_tpu_torch.ops.frontend import Features, extract_features
from gslam_tpu_torch.ops.matching import (
    Matches, match_descriptors, match_descriptors_gated,
)
from gslam_tpu_torch.ops.vocab import transform_sparse
from gslam_tpu_torch.opt.ba import (
    build_problem_from_arena, bundle_adjust, resolve_ba_kernels,
    write_back_to_arena,
)
from gslam_tpu_torch.utils.platform import require_device
from gslam_tpu_torch.utils.timer import Timer

RANSAC_B = 256          # hypotheses per frame (find_pnp_ransac's default)
RELOC_B = 1024          # per relocalization candidate: no pose prior
RELOC_CANDIDATES = 8


@dataclasses.dataclass
class SLAMConfig:
    """The JAX package's ``SLAMConfig`` for the RGB-D sequential path,
    with ``use_pallas`` renamed ``use_kernels``: True routes B1, B2, B4,
    B5, B6 and B7 through the CUDA kernels (their plain versions on CPU
    tensors; B5 / B6 up to 32 cameras, the plain Schur path above).  The
    fields of the paths that are not ported (pyramid scale,
    visual-inertial BA) and the JAX package's dispatch-fusion switches,
    which select between equivalent computations, are left out."""

    max_kps: int = 512
    fast_threshold: float = 0.06
    n_levels: int = 1              # >1: pyramid extraction (not ported)
    use_kernels: bool = True
    local_map_size: int = 2048     # point slab handed to tracking
    ba_window: int = 8             # covisible KFs in local BA
    ba_points: int = 1024
    ba_iters: int = 6
    ba_obs_per_point: int = 8
    enable_ba: bool = True
    kf_min_inlier_frac: float = 0.4
    kf_min_gap: int = 3
    kf_max_gap: int = 20
    match_max_dist: float = 64.0
    match_ratio: float = 0.85
    gate_radius_px: float = 40.0   # search-by-projection window
    dedup_radius_px: float = 4.0   # no new point near an existing one
    pnp_px_threshold: float = 2.0  # RANSAC inlier gate (pixels)
    min_track_inliers: int = 12
    reloc_min_inliers: int = 15    # PnP gate for BoW relocalization
    max_pose_jump: float = 1.0     # reject poses this far from the
    #                                motion-model prediction (m)
    max_lost_frames: int = 5       # coast this long before re-anchoring
    cap_frames: int = 256
    cap_points: int = 16384
    cap_obs: int = 65536
    seed: int = 0
    dispatch_batch: int = 1        # >1: batched dispatch (not ported)
    enable_map_hygiene: bool = True
    cull_min_visible: int = 10
    cull_min_ratio: float = 0.1
    hygiene_interval: int = 4      # KFs between refresh / KF-cull passes
    loop_global_ba_iters: int = 4  # post-loop global BA budget (0 = off)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to gslam_tpu_torch yet (ROADMAP Queue A "
        f"{item})")


class KeyframeSLAM:
    """``KeyframeSLAM(camera, SLAMConfig(...)).track(frame)`` per frame.

    Runs on ``device`` (the CUDA card unless the caller asks for the
    CPU).  With a ``vocabulary`` (a
    :class:`~gslam_tpu_torch.ops.vocab.Vocabulary` on ``device``) every
    keyframe enters the BoW database, loops are closed and a lost
    tracker relocalizes (``slam.loop_closer``).  RANSAC draws come from
    a ``torch.Generator`` on the device seeded with ``cfg.seed``, or,
    when ``uniforms`` is given, from ``uniforms()``, a callable returning
    the uniforms of each draw: (256, 4) for a tracked frame, (1024, 4)
    for a relocalization candidate (the tests replay the JAX package's
    key chain through it).  The loop closer draws from a generator of
    its own (``LoopCloser``'s ``seed`` and ``uniforms``).
    """

    def __init__(self, camera: Camera, config: Optional[SLAMConfig] = None,
                 vocabulary=None, device="cuda",
                 uniforms: Optional[Callable[[], torch.Tensor]] = None):
        self.device = require_device(device)
        self.camera = camera
        self.cfg = config or SLAMConfig()
        c = self.cfg
        if c.n_levels > 1:
            raise _not_ported("pyramid extraction (n_levels > 1)", "item 3")
        if c.dispatch_batch > 1:
            raise _not_ported("batched dispatch (dispatch_batch > 1)",
                              "item 12")
        self.timer = Timer()
        self.loop_closer: Optional[LoopCloser] = None
        if vocabulary is not None:
            # torch.device("cuda") and "cuda:0" name one card
            if torch.empty(0, device=self.device).device \
                    != vocabulary.device:
                raise ValueError(
                    f"the vocabulary lies on {vocabulary.device}, the SLAM "
                    f"system on {self.device}")
            # the absolute inlier floor scales with the keypoint budget;
            # aliasing protection is the match-fraction bar and the
            # covisibility exclusion, so nothing is tuned per run
            self.loop_closer = LoopCloser(
                vocabulary, c.cap_frames, use_kernels=c.use_kernels,
                min_inliers=max(12, c.max_kps // 16), min_gap=3,
                timer=self.timer)
        self.arena: MapArena = make_arena(
            cap_frames=c.cap_frames, cap_kps=c.max_kps,
            cap_points=c.cap_points, cap_obs=c.cap_obs, device=self.device)
        self._uniforms = uniforms
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(c.seed)
        ident = self._identity()
        self.pose_wc = ident              # current cam->world
        self.velocity = ident             # T_cw(t) * T_cw(t-1)^-1
        self.last_kf_id: int = -1
        self.frames_since_kf = 0
        self.initialized = False
        self._lost_frames = 0
        self.trajectory: List[torch.Tensor] = []   # pose_wc per frame
        self._traj_rel: List[tuple] = []   # (ref_kf, T_rel) per frame
        self.timestamps: List[float] = []
        self.stats: List[dict] = []
        self._last_track = None            # (slab_ids, matches, inliers)
        # host mirrors of arena counters: n_frames is exact (a frame
        # insert takes slot n_frames), n_points refreshed at the hygiene
        # cadence and used for stats rows only
        self._n_frames_host = 0
        self._n_points_host = 0

    # ------------------------------------------------------------------
    def _kf_tensor(self) -> torch.Tensor:
        """The last keyframe id as a 0-d int32 tensor on the device
        (filled there: no host copy)."""
        return torch.full((), self.last_kf_id, dtype=torch.int32,
                          device=self.device)

    def load_map(self, arena_or_path, pose_wc=None) -> None:
        """Resume / localize on a prebuilt map: an arena, or the path of
        an arena checkpoint.  Without ``pose_wc`` the camera starts at
        the last keyframe's pose (BoW relocalization engages by itself
        when tracking fails).  The BoW database is rebuilt from the
        stored descriptors."""
        arena = (load_arena(arena_or_path, device=self.device)
                 if isinstance(arena_or_path, str) else arena_or_path)
        self.arena = arena
        self.last_kf_id = int(arena.n_frames) - 1
        self._n_frames_host = self.last_kf_id + 1
        self._n_points_host = int(arena.n_points)
        self.initialized = (self.last_kf_id >= 0
                            and int(arena.point_valid.sum()) > 20)
        if pose_wc is not None:
            self.pose_wc = torch.as_tensor(pose_wc, dtype=torch.float32,
                                           device=self.device)
        elif self.last_kf_id >= 0:
            self.pose_wc = se3_inverse(
                arena.frame_pose[self.last_kf_id][:7])
        self.velocity = self._identity()
        if self.loop_closer is not None:
            for f in range(self.last_kf_id + 1):
                self._bow_add(f)

    def _identity(self) -> torch.Tensor:
        return torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32,
                            device=self.device)

    def _bow_add(self, fid: int) -> None:
        self.loop_closer.add_keyframe(
            fid, self.arena.frame_desc[fid],
            torch.arange(self.cfg.max_kps, device=self.device)
            < self.arena.frame_kp_count[fid])

    def _find_pnp(self, xyz, rays, valid, B=RANSAC_B,
                  max_depth=float("inf")):
        thr = (self.cfg.pnp_px_threshold / self.camera.fx) ** 2
        draw = dict(generator=self._gen) if self._uniforms is None \
            else dict(uniforms=self._uniforms())
        return find_pnp_ransac(xyz, rays, valid, threshold=thr, B=B,
                               max_depth=max_depth, **draw)

    def _kp_depths(self, depth: torch.Tensor, feats: Features):
        """Per-keypoint metric depth (K,): the depth image at the
        keypoints' pixels."""
        xi = feats.uv[:, 0].to(torch.int32).clamp(0, depth.shape[1] - 1)
        yi = feats.uv[:, 1].to(torch.int32).clamp(0, depth.shape[0] - 1)
        return depth[yi.long(), xi.long()]

    def _kp_colors(self, img: torch.Tensor, feats: Features):
        """(K, 3) per-keypoint colour (grey replicated)."""
        if img.dim() == 2:
            img = img[..., None]
        xi = feats.uv[:, 0].to(torch.int32).clamp(0, img.shape[1] - 1)
        yi = feats.uv[:, 1].to(torch.int32).clamp(0, img.shape[0] - 1)
        px = img[yi.long(), xi.long()]
        if px.shape[-1] == 1:
            px = px.expand(-1, 3)
        return px[:, :3].to(torch.float32)

    def track(self, frame: FrameData) -> torch.Tensor:
        """Track one frame; returns its cam->world pose (7,) on the
        device."""
        c = self.cfg
        if frame.depth is None:
            raise _not_ported("monocular tracking (frames without depth)",
                              "item 9")
        if frame.imu is not None and len(frame.imu) > 1:
            raise _not_ported("visual-inertial tracking (IMU samples)",
                              "item 13")
        dev = self.device
        img = torch.as_tensor(frame.image, device=dev)
        with self.timer.section("slam/extract"):
            feats = extract_features(img, max_kps=c.max_kps,
                                     threshold=c.fast_threshold,
                                     use_kernels=c.use_kernels)
            self.timer.block(feats.desc)
        self._cur_kp_depth = self._kp_depths(
            torch.as_tensor(frame.depth, device=dev), feats)
        self._cur_kp_color = self._kp_colors(img, feats)

        n_inliers = 0
        n_matches = 0
        n_features = None
        if not self.initialized:
            self._initialize(frame, feats)
        else:
            pred_cw = se3_mul(self.velocity, se3_inverse(self.pose_wc))
            pose_cw, n_matches, n_inliers, jump, n_features = \
                self._track_local_map(feats, pred_cw)
            if n_inliers >= c.min_track_inliers and jump <= c.max_pose_jump:
                self.velocity = se3_mul(pose_cw, self.pose_wc)
                self.pose_wc = se3_inverse(pose_cw)
                self.frames_since_kf += 1
                self._lost_frames = 0
                if self._need_keyframe(n_inliers, n_matches):
                    self._insert_keyframe(frame, feats, pose_cw)
            else:
                # lost: coast on the motion model (no keyframe at an
                # uncertain pose); try BoW relocalization when there is
                # a vocabulary; after max_lost_frames re-anchor with a
                # fresh keyframe
                self._lost_frames += 1
                self.pose_wc = se3_inverse(pred_cw)
                if not self._relocalize(feats) \
                        and self._lost_frames > c.max_lost_frames:
                    self._insert_keyframe(frame, feats,
                                          se3_inverse(self.pose_wc))
                    self._lost_frames = 0

        self.trajectory.append(self.pose_wc)
        kf = self.last_kf_id
        if kf >= 0:
            self._traj_rel.append(
                (kf, se3_mul(self.arena.frame_pose[kf][:7], self.pose_wc)))
        else:
            self._traj_rel.append((-1, self.pose_wc))
        self.timestamps.append(frame.timestamp)
        if n_features is None:
            n_features = int(feats.count)
        self.stats.append({
            "n_features": n_features, "n_matches": n_matches,
            "n_inliers": n_inliers, "n_kf": self._n_frames_host,
            "n_points": self._n_points_host})
        return self.pose_wc

    # ------------------------------------------------------------------
    def _initialize(self, frame: FrameData, feats: Features) -> None:
        """Map bootstrap from depth: the first keyframe at the current
        pose, with its points."""
        self._insert_keyframe(frame, feats, se3_inverse(self.pose_wc),
                              run_ba=False)
        self._n_points_host = int(self.arena.n_points)
        self.initialized = self._n_points_host > 20

    def _slab(self, arena: MapArena, last_kf):
        """Covisibility slab of ``last_kf``: (ids, xyz, desc, valid)."""
        c = self.cfg
        uniq = covis_union_ids(arena, last_kf, c.local_map_size,
                               window=min(c.ba_window, c.cap_frames - 1),
                               min_common=5)
        slab_ids = uniq.clamp_min(0).long()
        return (slab_ids, arena.point_xyz[slab_ids],
                arena.point_desc[slab_ids],
                (uniq >= 0) & arena.point_valid[slab_ids])

    def _track_local_map(self, feats: Features, pose_cw_pred):
        """Slab gather -> projection under the predicted pose -> gated
        matching -> PnP RANSAC + GN refine, then ONE packed fetch of
        (match count, inlier count, pose jump, feature count)."""
        c = self.cfg
        cam = self.camera
        arena = self.arena
        with self.timer.section("slam/track_fused"):
            last_kf = self._kf_tensor()
            slab_ids, xyz, desc, valid = self._slab(arena, last_kf)
            uv_pred, proj_ok = cam.project(se3_apply(pose_cw_pred, xyz))
            visible = valid & proj_ok
            match = (match_hamming_gated if c.use_kernels
                     else match_descriptors_gated)
            m = match(desc, visible, feats.desc, feats.valid, uv_pred,
                      feats.uv, c.gate_radius_px, max_dist=c.match_max_dist,
                      ratio=c.match_ratio)
            rays = cam.unproject(feats.uv[m.idx.clamp_min(0).long()])[:, :2]
            T, inl, n = self._find_pnp(xyz, rays, m.valid)
            # landmark tracking statistics (visible / found)
            new_vis = arena.point_visible.index_add(0, slab_ids,
                                                    visible.to(torch.int32))
            new_fnd = arena.point_found.index_add(
                0, slab_ids, (m.valid & inl).to(torch.int32))
            jump = torch.linalg.vector_norm(
                se3_inverse(T)[:3] - se3_inverse(pose_cw_pred)[:3])
            sc = torch.stack([m.count.to(torch.float32),
                              n.to(torch.float32), jump,
                              feats.count.to(torch.float32)]).cpu()
        self.arena = arena.replace(point_visible=new_vis,
                                   point_found=new_fnd)
        self._last_track = (slab_ids, m, inl)
        sc = sc.tolist()
        return T, int(sc[0]), int(sc[1]), float(sc[2]), int(sc[3])

    # ------------------------------------------------------------------
    def _need_keyframe(self, n_inliers: int, n_matches: int) -> bool:
        c = self.cfg
        if self.frames_since_kf < c.kf_min_gap:
            return False
        if self.frames_since_kf >= c.kf_max_gap:
            return True
        ref = max(n_matches, 1)
        return (n_inliers / ref) < c.kf_min_inlier_frac or \
            n_inliers < 2 * c.min_track_inliers

    def _kp_meta(self, feats: Features) -> torch.Tensor:
        z = torch.zeros_like(feats.score)
        return torch.stack([feats.score, feats.angle, z, z], -1)

    def _insert_frame_only(self, frame: FrameData, feats: Features,
                           pose_cw) -> int:
        if self._n_frames_host >= self.cfg.cap_frames:
            return -1                    # arena frame capacity exhausted
        self.arena, _ = insert_frame(
            self.arena, sim3_from_se3(pose_cw), frame.timestamp, feats.uv,
            self._kp_meta(feats), feats.desc, feats.count,
            kp_depth=self._cur_kp_depth)
        fid = self._n_frames_host        # exact mirror of the device slot
        self._n_frames_host = fid + 1
        return fid

    def _fuse_tracked(self, arena, fid, pose_cw, feats, slab_ids,
                      m: Matches, inl):
        """Observations of tracked points: RANSAC inliers, and gated
        matches that reproject within twice the PnP gate under the final
        pose.  Returns (arena, (K,) matched-keypoint mask)."""
        c = self.cfg
        uv_f, proj_ok = self.camera.project(
            se3_apply(pose_cw, arena.point_xyz[slab_ids]))
        kp = m.idx.clamp_min(0)
        err = torch.linalg.vector_norm(uv_f - feats.uv[kp.long()], dim=-1)
        fuse_ok = m.valid & proj_ok & (err < 2.0 * c.pnp_px_threshold)
        obs_ok = (m.valid & inl) | fuse_ok
        arena = add_observations(arena, fid,
                                 torch.where(obs_ok, slab_ids, -1), kp,
                                 obs_ok)
        matched = set_rows(torch.zeros(c.max_kps, dtype=torch.bool,
                                       device=self.device), kp, obs_ok)
        return arena, matched

    def _near_existing(self, arena, last_kf, pose_cw, kp_uv):
        """(K,) mask: keypoint within dedup_radius_px of a valid map
        point of ``last_kf``'s slab projected into this frame."""
        _, xyz, _, valid = self._slab(arena, last_kf)
        uvs, pok = self.camera.project(se3_apply(pose_cw, xyz))
        d2 = ((kp_uv[:, None, :] - uvs[None, :, :]) ** 2).sum(-1)
        d2 = torch.where((valid & pok)[None, :], d2, float("inf"))
        return d2.amin(1) < self.cfg.dedup_radius_px ** 2

    def _new_points(self, arena, fid, pose_cw, feats, newok):
        """Points from depth for the ``newok`` keypoints, observed by
        ``fid``."""
        c = self.cfg
        d = self._cur_kp_depth
        rays3 = self.camera.unproject(feats.uv)
        pts_cam = rays3 / rays3[:, 2:3] * d[:, None]
        pose_wc = se3_inverse(pose_cw)
        pts_w = se3_apply(pose_wc, pts_cam)
        nrm = pts_w - pose_wc[:3]
        nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1,
                                             keepdim=True).clamp_min(1e-9)
        arena, pids = insert_points(arena, pts_w, feats.desc, newok,
                                    ref_frame=fid, normal=nrm,
                                    color=self._cur_kp_color)
        return add_observations(
            arena, fid, pids,
            torch.arange(c.max_kps, dtype=torch.int32, device=self.device),
            newok)

    def _insert_keyframe(self, frame: FrameData, feats: Features, pose_cw,
                         run_ba: bool = True) -> None:
        """Frame write; for a tracked frame, the fuse of its tracked
        observations; new points from depth away from existing ones.

        The JAX package runs a tracked frame's insertion as one fused
        graph and the bootstrap stage by stage; in eager PyTorch both
        are this one sequence of operations.  At frame capacity a
        tracked frame's insertion drops every write and raises the
        ``overflow`` flag, as the fused graph does."""
        c = self.cfg
        tracked = self.initialized and self._last_track is not None
        with self.timer.section("slam/keyframe"):
            fid = self._insert_frame_only(frame, feats, pose_cw)
            if fid < 0:
                if tracked:
                    self.arena = self.arena.replace(
                        overflow=torch.ones_like(self.arena.overflow))
                return
            matched = torch.zeros(c.max_kps, dtype=torch.bool,
                                  device=self.device)
            if tracked:
                slab_ids, m, inl = self._last_track
                self.arena, matched = self._fuse_tracked(
                    self.arena, fid, pose_cw, feats, slab_ids, m, inl)
            d = self._cur_kp_depth
            newok = feats.valid & ~matched & (d > 1e-3) & torch.isfinite(d)
            if self.initialized:
                newok = newok & ~self._near_existing(
                    self.arena, self._kf_tensor(), pose_cw, feats.uv)
            self.arena = self._new_points(self.arena, fid, pose_cw, feats,
                                          newok)
        self._finish_keyframe(fid, run_ba)

    def _finish_keyframe(self, fid: int, run_ba: bool) -> None:
        """After inserting keyframe ``fid``: local BA, loop closing,
        then map hygiene."""
        self.last_kf_id = fid
        self.frames_since_kf = 0
        if run_ba and self.cfg.enable_ba and self._n_frames_host >= 2:
            self._local_ba()
        if self.loop_closer is not None:
            with self.timer.section("slam/loop"):
                self._bow_add(fid)
                self.arena, closed = self.loop_closer.close(
                    self.arena, self.camera, fid,
                    global_ba_iters=self.cfg.loop_global_ba_iters)
                if closed:
                    self.pose_wc = se3_inverse(
                        self.arena.frame_pose[fid][:7])
                    self.velocity = self._identity()
                self.timer.block(self.arena.frame_pose)
        if self.cfg.enable_map_hygiene:
            self._map_hygiene()

    def _map_hygiene(self) -> None:
        """Found-ratio cull every keyframe; at the hygiene interval,
        refresh descriptors and normals, erase at most one redundant
        keyframe, and compact the points when allocation nears the cap."""
        c = self.cfg
        with self.timer.section("slam/hygiene"):
            self.arena = cull_by_found_ratio(
                self.arena, min_visible=c.cull_min_visible,
                min_ratio=c.cull_min_ratio)
            nf = self._n_frames_host
            if nf >= 8 and nf % c.hygiene_interval == 0:
                self.arena = refresh_points(self.arena,
                                            max_obs=c.ba_obs_per_point)
                red = redundant_frames(self.arena).cpu().numpy()
                red[0] = False                  # gauge keyframe stays
                red[max(0, nf - 3):] = False    # never the newest views
                ids = np.nonzero(red)[0]
                if len(ids):
                    self.arena = erase_frame(self.arena, int(ids[0]))
                n_alloc = int(self.arena.n_points)
                self._n_points_host = n_alloc
                if n_alloc > 0.8 * self.arena.cap_points:
                    n_valid = int(self.arena.point_valid.sum())
                    if n_valid < 0.7 * n_alloc:
                        self.arena, _ = compact_arena(self.arena)

    def _relocalize(self, feats: Features) -> bool:
        """BoW relocalization after tracking loss: query the keyframe
        database with the frame's BoW vector, PnP-verify the frame
        against the covisibility neighbourhood of each of the best
        candidates (BoW retrieval ranks, geometry decides), and reset the
        pose and the motion model.  One draw per evaluated candidate, in
        rank order; the candidates' results are read back together."""
        c = self.cfg
        lc = self.loop_closer
        if lc is None or self._n_frames_host < 2:
            return False
        bow, _ = transform_sparse(lc.voc, feats.desc, feats.valid,
                                  use_kernels=lc.use_kernels)
        scores = lc.query(bow)
        good = [int(x) for x in np.argsort(-scores)[:RELOC_CANDIDATES]]
        good = good[:next((i for i, x in enumerate(good)
                           if scores[x] < lc.min_score), len(good))]
        if not good:
            return False
        # a relocalized camera lies inside the mapped region, and PnP
        # inliers count within a scene-scale depth (the gates of
        # LoopCloser.verify: without them a lower inlier bar would admit
        # degenerate RANSAC poses)
        lo, hi, margin = map_volume(self.arena, self._n_frames_host)
        max_depth = 4.0 * float((hi - lo).max()) + 10.0
        arena = self.arena
        packed = []
        for cand in good:
            pids = covis_union_ids(
                arena, torch.full((), cand, dtype=torch.int32,
                                  device=self.device),
                c.local_map_size, window=4, min_common=5)
            pslot = pids.clamp_min(0).long()
            ok = (pids >= 0) & arena.point_valid[pslot]
            m = match_descriptors(arena.point_desc[pslot], ok, feats.desc,
                                  feats.valid, ratio=0.9)
            rays = self.camera.unproject(
                feats.uv[m.idx.clamp_min(0).long()])[:, :2]
            T, _, n = self._find_pnp(arena.point_xyz[pslot], rays, m.valid,
                                     B=RELOC_B, max_depth=max_depth)
            packed.append(torch.cat([T, se3_inverse(T)[:3],
                                     n.to(torch.float32)[None]]))
        packed = torch.stack(packed).cpu().numpy()       # one fetch
        results = []               # (n, rank, centre)
        for k in range(len(good)):
            center = packed[k, 7:10]
            if inside_volume(center, lo, hi, margin):
                results.append((int(packed[k, 10]), k, center))
        if not results:
            return False
        results.sort(key=lambda r: -r[0])
        n0, k0, c0 = results[0]
        accept = n0 >= c.reloc_min_inliers
        if not accept:
            # independent candidate neighbourhoods solving to the same
            # camera centre verify each other: accept at half the bar
            # when at least 2 candidates agree within 1 m
            half = max(6, c.reloc_min_inliers // 2)
            agree = [r for r in results
                     if r[0] >= half and np.linalg.norm(r[2] - c0) < 1.0]
            accept = n0 >= half and len(agree) >= 2
        if not accept:
            return False
        self.pose_wc = se3_inverse(torch.from_numpy(packed[k0, :7]).to(
            self.device))
        self.velocity = self._identity()
        self._lost_frames = 0
        # the tracker's local map re-anchors at the relocalization site
        self.last_kf_id = good[k0]
        return True

    # ------------------------------------------------------------------
    def _local_ba_step(self, arena: MapArena, kf: torch.Tensor):
        """Window selection, problem extraction, LM, write-back; returns
        (arena, pose_wc of ``kf``).  The B5 / B6 kernels run when
        ``resolve_ba_kernels`` allows (at most 32 cameras), the plain
        Schur path above that."""
        c = self.cfg
        nbr, _ = covisibility_topk(arena, kf, k=c.ba_window - 1,
                                   min_common=5)
        cam_ids = torch.cat([kf.reshape(1).to(torch.int32), nbr])[
            :c.ba_window]
        point_ids = covis_union_ids(arena, kf, c.ba_points,
                                    window=c.ba_window - 1, min_common=5)
        oldest = torch.argmin(torch.where(cam_ids >= 0, cam_ids, INT32_MAX))
        slots = torch.arange(cam_ids.shape[0], device=self.device)
        fixed = (slots == oldest) | (cam_ids == 0)
        problem, _ = build_problem_from_arena(
            arena, cam_ids, point_ids, fixed, self.camera,
            max_obs_per_point=c.ba_obs_per_point)
        problem, _ = bundle_adjust(
            problem, iters=c.ba_iters,
            use_kernels=resolve_ba_kernels(c.use_kernels, cam_ids.shape[0]))
        arena = write_back_to_arena(arena, problem, cam_ids, point_ids)
        return arena, se3_inverse(arena.frame_pose[kf.long()][:7])

    def _local_ba(self) -> None:
        with self.timer.section("slam/local_ba"):
            kf = self._kf_tensor()
            self.arena, self.pose_wc = self._local_ba_step(self.arena, kf)
            self.timer.block(self.pose_wc)

    # -- evaluation helpers -------------------------------------------------
    def positions(self) -> np.ndarray:
        """(N, 3) camera centres as tracked, one fetch."""
        if not self.trajectory:
            return np.zeros((0, 3))
        return torch.stack(self.trajectory)[:, :3].cpu().numpy()

    def corrected_trajectory(self) -> np.ndarray:
        """(N, 7) cam->world poses re-based on each frame's reference
        keyframe's final pose (the reference's SaveTrajectory
        semantics)."""
        if not self._traj_rel:
            return np.zeros((0, 7))
        kf_ids = torch.tensor([k for k, _ in self._traj_rel],
                              device=self.device)
        rels = torch.stack([r for _, r in self._traj_rel])
        sel = kf_ids >= 0
        T_wk = se3_inverse(self.arena.frame_pose[kf_ids.clamp_min(0), :7])
        out = torch.where(sel[:, None], se3_mul(T_wk, rels), rels)
        return out.cpu().numpy()

    def corrected_positions(self) -> np.ndarray:
        tr = self.corrected_trajectory()
        return tr[:, :3] if len(tr) else np.zeros((0, 3))
