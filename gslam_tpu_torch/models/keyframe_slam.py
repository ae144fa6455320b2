"""Keyframe SLAM: track against the local map, keyframe mapping, local
bundle adjustment, loop closure, relocalization, map hygiene.

Counterpart of ``gslam_tpu/models/keyframe_slam.py`` for frames with
depth (RGB-D) and without (monocular), with or without IMU samples, one
frame per ``track`` call or K per ``track_batch`` dispatch:

  track:    extract (FAST + NMS (B1), BRIEF (B2); once per level of an
            image pyramid with ``n_levels`` > 1) -> covisibility slab ->
            projection under the constant-velocity prediction -> gated
            Hamming matching (B4) -> PnP RANSAC + GN refine
  batch:    ``track_batch`` runs K frames of that chain against one slab
            with the keyframe and tracking-lost predicates evaluated on
            the device, and fetches one packed (K, 19) summary; the host
            accepts the frames before the first that trips a predicate
            and hands that frame's frozen state to the keyframe or
            relocalization path.  On the card the K-frame body is one
            captured CUDA graph (:class:`BatchGraph`)
  IMU:      a frame's samples are preintegrated (Forster factor) and
            composed since the last keyframe; the gyro delta replaces the
            rotation of the constant-velocity prediction; a keyframe emits
            the composed factor (for VI BA) and a rotation-only edge (for
            the loop pose graph); once enough factors exist, gravity,
            velocities and (mono) scale are aligned
            (``_maybe_vi_init``), and local BA becomes the joint
            visual-inertial LM (:func:`~gslam_tpu_torch.opt.vi.
            vi_bundle_adjust`, B5 / B6 as in local BA)
  bootstrap: RGB-D, the first keyframe with points from depth; mono,
            the two-view H / E initialization between the first two
            frames with enough matches
  keyframe: promotion decided on the host from the frame's one packed
            fetch (match count, inlier count, pose jump, feature count);
            frame insert, fuse of tracked observations, new points from
            depth away from existing ones, or (mono) triangulated
            against the previous keyframe
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
counters, so a tracked frame costs one device fetch (a keyframe with IMU
factors one more, the factor's).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.imu import (
    ImuFactor, compose_factors, identity_factor, preintegrate_full,
)
from gslam_tpu_torch.core.se3 import (
    se3_apply, se3_identity, se3_inverse, se3_mul,
)
from gslam_tpu_torch.core.sim3 import sim3_from_se3
from gslam_tpu_torch.core.so3 import quat_conj, quat_to_matrix
from gslam_tpu_torch.datasets.base import FrameData
from gslam_tpu_torch.estimation.epipolar import triangulate
from gslam_tpu_torch.estimation.init2view import (
    two_view_draws, two_view_geometry,
)
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
from gslam_tpu_torch.ops.cuda import brief, fastnms, matcher
from gslam_tpu_torch.ops.cuda.matcher import match_hamming_gated
from gslam_tpu_torch.ops.frontend import (
    Features, extract_features, extract_features_pyramid,
)
from gslam_tpu_torch.ops.matching import (
    Matches, match_descriptors, match_descriptors_gated,
)
from gslam_tpu_torch.ops.vocab import transform_sparse
from gslam_tpu_torch.opt.ba import (
    build_problem_from_arena, bundle_adjust, resolve_ba_kernels,
    write_back_to_arena,
)
from gslam_tpu_torch.opt.vi import (
    ViProblem, estimate_gravity_velocity, stack_factors, vi_bundle_adjust,
)
from gslam_tpu_torch.utils.platform import require_device
from gslam_tpu_torch.utils.timer import Timer

RANSAC_B = 256          # hypotheses per frame (find_pnp_ransac's default)
RELOC_B = 1024          # per relocalization candidate: no pose prior
RELOC_CANDIDATES = 8
MONO_MIN_MATCHES = 30   # two-view bootstrap: matches to try, inliers to
MONO_MIN_INLIERS = 20   # accept


@dataclasses.dataclass
class SLAMConfig:
    """The JAX package's ``SLAMConfig`` with ``use_pallas`` renamed
    ``use_kernels``: True routes B1, B2, B4, B5, B6 and B7 through the
    CUDA kernels (their plain versions on CPU tensors; B5 / B6 up to 32
    cameras, the plain Schur path above).  The JAX package's
    dispatch-fusion switches, which select between equivalent
    computations, are left out."""

    max_kps: int = 512
    fast_threshold: float = 0.06
    n_levels: int = 1              # >1: pyramid extraction
    pyramid_scale: float = 1.25
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
    dispatch_batch: int = 1        # frames per track_batch dispatch
    enable_map_hygiene: bool = True
    cull_min_visible: int = 10
    cull_min_ratio: float = 0.1
    hygiene_interval: int = 4      # KFs between refresh / KF-cull passes
    loop_global_ba_iters: int = 4  # post-loop global BA budget (0 = off)
    # visual-inertial estimation (frames carrying IMU windows)
    enable_vi_ba: bool = True      # joint VI local BA once initialized
    vi_min_factors: int = 3        # inter-keyframe factors before VI init
    vi_ba_iters: int = 8
    imu_gyro_noise: float = 1e-3   # continuous-time noise densities
    imu_accel_noise: float = 1e-2


def _factor_to_numpy(f: ImuFactor) -> ImuFactor:
    """A factor's fields as numpy arrays, in one fetch."""
    flat = torch.cat([x.reshape(-1) for x in f]).cpu().numpy()
    out, at = [], 0
    for x in f:
        out.append(flat[at:at + x.numel()].reshape(tuple(x.shape)))
        at += x.numel()
    return ImuFactor(*out)


_PAD_FACTOR = ImuFactor(*(x.numpy() for x in identity_factor()))


class BatchResult(NamedTuple):
    """What the K-frame body of ``track_batch`` hands back."""

    rows: torch.Tensor        # (K, 19): pose_wc, rel to the last keyframe,
    #                           n_inliers, n_matches, n_features, first
    #                           trigger, ok (columns 14-18)
    pose_wc: torch.Tensor     # (7,) after the last accepted frame
    velocity: torch.Tensor    # (7,) after the last accepted frame
    visible: torch.Tensor     # (S,) int32 slab visits of the accepted frames
    found: torch.Tensor       # (S,) int32 and the first trigger frame
    feats: Features           # the first trigger frame's features,
    matches: Matches          # matches, inlier mask and PnP pose (frame 0's
    inliers: torch.Tensor     # when no frame triggers)
    T: torch.Tensor


def tensor_leaves(x) -> List[torch.Tensor]:
    """The tensors of a nest of named tuples, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in tensor_leaves(v)]


def _rebuild(like, values):
    """A tuple or named tuple of ``like``'s type holding ``values``."""
    values = list(values)
    return type(like)(*values) if hasattr(like, "_fields") else tuple(values)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    return _rebuild(x, (_clone(v) for v in x))


def _where(cond: torch.Tensor, a, b):
    """``torch.where(cond, a, b)`` over two nests of tuples."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    return _rebuild(a, (_where(cond, u, v) for u, v in zip(a, b)))


def body_launches() -> Dict[str, int]:
    """The launch counters of the kernels in the K-frame body: B1, B2
    and B4."""
    return {"fast_nms": fastnms.launches, "brief": brief.launches,
            "gated_matcher": matcher.gated_launches}


class BatchGraph:
    """The K-frame body of ``track_batch`` captured as one CUDA graph:
    the counterpart of the JAX package's single ``lax.scan`` dispatch.

    The first inputs are cloned into static buffers, the body runs once
    on a side stream (warm-up: libraries, caches and the kernels' first
    launches), then once under ``torch.cuda.graph``.  A call copies its
    inputs into the static buffers and replays; the outputs are the
    graph's own buffers, overwritten by the next replay.  Nothing falls
    back to the eager body: a failed capture or replay raises.

    The kernel wrappers count launches when Python calls them, so a
    replay moves no counter: ``captured`` holds the launches one replay
    makes (counted during the capture, which launches nothing on the
    card) and ``replays`` the replays so far.  ``capture_s`` and
    ``pool_bytes`` (the graph's memory pool) are for the record."""

    def __init__(self, body: Callable, inputs: Dict[str, torch.Tensor]):
        self.static = {k: v.clone() for k, v in inputs.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body(self.static)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = body_launches()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph):
            self.out = body(self.static)
        self.graph.instantiate()
        self.capture_s = time.perf_counter() - t0
        after = body_launches()
        self.captured = {k: after[k] - before[k] for k in after}
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.replays = 0

    def __call__(self, inputs: Dict[str, torch.Tensor]) -> BatchResult:
        for k, v in inputs.items():
            self.static[k].copy_(v)
        self.graph.replay()
        self.replays += 1
        return self.out


class KeyframeSLAM:
    """``KeyframeSLAM(camera, SLAMConfig(...)).track(frame)`` per frame,
    or ``.track_batch(frames)`` for ``cfg.dispatch_batch`` frames a
    dispatch.

    Runs on ``device`` (the CUDA card unless the caller asks for the
    CPU).  With a ``vocabulary`` (a
    :class:`~gslam_tpu_torch.ops.vocab.Vocabulary` on ``device``) every
    keyframe enters the BoW database, loops are closed and a lost
    tracker relocalizes (``slam.loop_closer``).  RANSAC draws come from
    a ``torch.Generator`` on the device seeded with ``cfg.seed``, or,
    when ``uniforms`` is given, from ``uniforms()``, a callable returning
    the uniforms of each draw: (256, 4) for a tracked frame (a batch
    calls it once for each of its K frames before it runs), (1024, 4)
    for a relocalization candidate, and the pair ((256, 8), (256, 4))
    for the monocular two-view bootstrap (the tests replay the JAX
    package's key chain through it).  The loop closer draws from a
    generator of its own (``LoopCloser``'s ``seed`` and ``uniforms``).
    """

    def __init__(self, camera: Camera, config: Optional[SLAMConfig] = None,
                 vocabulary=None, device="cuda",
                 uniforms: Optional[Callable[[], torch.Tensor]] = None):
        self.device = require_device(device)
        self.camera = camera
        # the lens parameters resident on the device now, so that no
        # host-to-device copy lands inside a batch graph's capture
        camera.params_on(self.device)
        self.cfg = config or SLAMConfig()
        c = self.cfg
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
        self._prev_feats: Optional[Features] = None   # mono bootstrap
        self._prev_frame: Optional[FrameData] = None
        self._graphs: Dict[tuple, BatchGraph] = {}    # per batch shape
        # False: the K-frame body runs eagerly on the card too (the
        # CLI's -debug.nojit), the counterpart of jax_disable_jit
        self.batch_graphs = True
        self.batch_accepted: List[int] = []  # frames each dispatch took
        # VI state: the factor composed since the last keyframe, the
        # inter-keyframe factors (numpy) for VI BA and rotation-only
        # edges for the loop pose graph, velocities, gravity and biases
        self._imu_acc: Optional[ImuFactor] = None
        self.imu_edges: List[tuple] = []     # (kf_i, kf_j, dq (4,))
        self.imu_factors: List[tuple] = []   # (kf_i, kf_j, ImuFactor)
        self._imu_factor_idx: Dict[tuple, ImuFactor] = {}
        self.kf_vel: Dict[int, np.ndarray] = {}   # kf id -> world velocity
        self.gravity_w: Optional[np.ndarray] = None   # (3,) after VI init
        self.vi_ready = False
        self.bias_g = np.zeros(3, np.float32)
        self.bias_a = np.zeros(3, np.float32)
        self.vi_costs: Optional[torch.Tensor] = None  # last VI LM's costs
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
        return se3_identity(device=self.device)

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
        img = torch.as_tensor(frame.image, device=self.device)
        with self.timer.section("slam/extract"):
            if c.n_levels > 1:
                feats = extract_features_pyramid(
                    img, max_kps=c.max_kps, threshold=c.fast_threshold,
                    n_levels=c.n_levels, scale=c.pyramid_scale,
                    use_kernels=c.use_kernels)
            else:
                feats = extract_features(img, max_kps=c.max_kps,
                                         threshold=c.fast_threshold,
                                         use_kernels=c.use_kernels)
            self.timer.block(feats.desc)
        self._set_keypoint_samples(frame, img, feats)
        imu_delta = self._preintegrate(frame)

        n_inliers = 0
        n_matches = 0
        n_features = None
        if not self.initialized:
            self._initialize(frame, feats)
        else:
            if imu_delta is not None:
                # gyro-aided motion model: the rotation of T_cw(t) o
                # T_wc(t-1) is conj(dq) when dq rotates body(t-1) ->
                # body(t) (camera frame == IMU frame)
                self.velocity = torch.cat([self.velocity[:3],
                                           quat_conj(imu_delta.dq)])
            pred_cw = se3_mul(self.velocity, se3_inverse(self.pose_wc))
            pose_cw, n_matches, n_inliers, jump, n_features = \
                self._track_local_map(feats, pred_cw)
            ok = n_inliers >= c.min_track_inliers and jump <= c.max_pose_jump
            self._after_pnp(frame, feats, pose_cw, ok, ok and (
                self._need_keyframe(n_inliers, n_matches,
                                    self.frames_since_kf + 1)))
        self._prev_feats = feats
        self._prev_frame = frame
        if n_features is None:
            n_features = int(feats.count)
        self._record(frame, n_features, n_matches, n_inliers)
        return self.pose_wc

    def _preintegrate(self, frame: FrameData) -> Optional[ImuFactor]:
        """The frame's IMU window as a full preintegrated factor (None
        without at least two samples), composed onto the factor since
        the last keyframe.  Timestamps are rebased in float64 before the
        float32 cast: absolute epochs (~1.4e9 s) have ~128 s of float32
        resolution, which would collapse millisecond steps to 0."""
        if frame.imu is None or len(frame.imu) <= 1:
            return None
        c = self.cfg
        with self.timer.section("slam/imu"):
            win = np.array(frame.imu, np.float64)
            win[:, 0] -= win[0, 0]
            delta = preintegrate_full(
                torch.from_numpy(win.astype(np.float32)).to(self.device),
                gyro_noise=c.imu_gyro_noise, accel_noise=c.imu_accel_noise)
            self._imu_acc = delta if self._imu_acc is None \
                else compose_factors(self._imu_acc, delta)
        return delta

    def _set_keypoint_samples(self, frame: FrameData, img: torch.Tensor,
                              feats: Features) -> None:
        """The frame's depth (None without depth) and colour at its
        keypoints, for keyframe insertion."""
        self._cur_kp_depth = None if frame.depth is None else \
            self._kp_depths(torch.as_tensor(frame.depth, device=self.device),
                            feats)
        self._cur_kp_color = self._kp_colors(img, feats)

    def _after_pnp(self, frame: FrameData, feats: Features, pose_cw,
                   ok: bool, need_kf: bool) -> None:
        """track()'s control flow once PnP has run: take the pose (and a
        keyframe when ``need_kf``), or coast as lost."""
        c = self.cfg
        if ok:
            self.velocity = se3_mul(pose_cw, self.pose_wc)
            self.pose_wc = se3_inverse(pose_cw)
            self.frames_since_kf += 1
            self._lost_frames = 0
            if need_kf:
                self._insert_keyframe(frame, feats, pose_cw)
            return
        # lost: coast on the motion model (no keyframe at an uncertain
        # pose); try BoW relocalization when there is a vocabulary; after
        # max_lost_frames re-anchor with a fresh keyframe
        self._lost_frames += 1
        self.pose_wc = se3_inverse(se3_mul(self.velocity,
                                           se3_inverse(self.pose_wc)))
        if not self._relocalize(feats) \
                and self._lost_frames > c.max_lost_frames:
            self._insert_keyframe(frame, feats, se3_inverse(self.pose_wc))
            self._lost_frames = 0

    def _record(self, frame: FrameData, n_features: int, n_matches: int,
                n_inliers: int) -> None:
        """The frame's trajectory, keyframe-relative pose, timestamp and
        stats row."""
        self.trajectory.append(self.pose_wc)
        kf = self.last_kf_id
        if kf >= 0:
            self._traj_rel.append(
                (kf, se3_mul(self.arena.frame_pose[kf][:7], self.pose_wc)))
        else:
            self._traj_rel.append((-1, self.pose_wc))
        self.timestamps.append(frame.timestamp)
        self.stats.append({
            "n_features": n_features, "n_matches": n_matches,
            "n_inliers": n_inliers, "n_kf": self._n_frames_host,
            "n_points": self._n_points_host})

    # ------------------------------------------------------------------
    def _initialize(self, frame: FrameData, feats: Features) -> None:
        """Map bootstrap.  With depth: the first keyframe at the current
        pose, with its points.  Without: two-view H / E geometry between
        the previous frame and this one (at least 30 matches, 20
        inliers), the previous frame as keyframe 0 at the identity, this
        one as keyframe 1 at T_21 (unit baseline), and the triangulated
        inliers as points observed by both.

        Unlike the JAX package, the port also wants 20 of those inliers
        to triangulate at a depth in (0.1, 100), the window the points
        must lie in: at the small parallax of two consecutive frames some
        draws give a motion whose inliers all lie beyond it, a map of a
        point or two that nothing tracks against (ROADMAP Queue C).  Such
        a pair is skipped like one with too few inliers, and the next
        frame tries again."""
        if self._cur_kp_depth is not None:
            self._insert_keyframe(frame, feats, se3_inverse(self.pose_wc),
                                  run_ba=False)
            self._n_points_host = int(self.arena.n_points)
            self.initialized = self._n_points_host > 20
            return
        pf = self._prev_feats
        if pf is None:
            return
        cam = self.camera
        m = match_descriptors(pf.desc, pf.valid, feats.desc, feats.valid)
        if int(m.count) < MONO_MIN_MATCHES:
            return
        kp = m.idx.clamp_min(0).long()
        rays1 = cam.unproject(pf.uv)[:, :2]
        rays2 = cam.unproject(feats.uv[kp])[:, :2]
        # H / E model selection: the 8-point essential solve degenerates
        # on (near-)planar bootstrap scenes, which the homography covers
        tv = two_view_geometry(rays1, rays2, m.valid, sigma=1.0 / cam.fx,
                               uniforms=self._two_view_draws())
        if int(tv.n_inliers) < MONO_MIN_INLIERS:
            return
        I7 = self._identity()
        X, d1 = triangulate(I7, tv.T_21, rays1, rays2)
        good = tv.inliers & (d1 > 0.1) & (d1 < 100.0)
        if int(good.sum()) < MONO_MIN_INLIERS:
            return
        kf0 = self._insert_frame_only(self._prev_frame, pf, I7)
        self.arena, pids = insert_points(self.arena, X, pf.desc, good,
                                         ref_frame=kf0)
        self.arena = add_observations(self.arena, kf0, pids,
                                      self._kp_range(), good)
        kf1 = self._insert_frame_only(frame, feats, tv.T_21)
        self.arena = add_observations(self.arena, kf1, pids, kp,
                                      good & m.valid)
        self.pose_wc = se3_inverse(tv.T_21)
        self.last_kf_id = kf1
        self.initialized = True
        # the next inter-keyframe factor spans (kf1, next keyframe] only
        self._imu_acc = None

    def _two_view_draws(self):
        if self._uniforms is not None:
            return self._uniforms()
        return two_view_draws(generator=self._gen, device=self.device)

    def _kp_range(self) -> torch.Tensor:
        return torch.arange(self.cfg.max_kps, dtype=torch.int32,
                            device=self.device)

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
    def track_batch(self, frames: List[FrameData]) -> List[torch.Tensor]:
        """Track ``frames`` with ``cfg.dispatch_batch`` (K) frames a
        dispatch; returns each frame's cam->world pose (7,) on the device,
        as a sequence of ``track`` calls would.

        Each dispatch is :meth:`_batch_body` over K frames against one
        covisibility slab: one copy of the K images to the device, one
        draw of their RANSAC uniforms, one packed (K, 19) fetch.  The
        frames before the first that needs a keyframe or lost tracking
        are accepted; that frame goes to the keyframe / relocalization
        path from its frozen state (:meth:`_handle_trigger_frame`).
        ``track`` takes the frame instead when K is 1, the map is not
        initialized, the batch's first frame carries IMU samples, or
        fewer than K frames are left."""
        c = self.cfg
        K = max(int(c.dispatch_batch), 1)
        dev = self.device
        out: List[torch.Tensor] = []
        i = 0
        while i < len(frames):
            fr = frames[i]
            if (K == 1 or not self.initialized or fr.imu is not None
                    or c.n_levels > 1 or len(frames) - i < K):
                out.append(self.track(fr))
                i += 1
                continue
            batch = frames[i:i + K]
            imgs = torch.from_numpy(np.stack(
                [np.asarray(f.image, np.float32) for f in batch])).to(dev)
            uniforms = self._batch_uniforms(K)
            with self.timer.section("slam/track_batch"):
                slab_ids, xyz, desc, valid = self._slab(self.arena,
                                                        self._kf_tensor())
                res = self._run_batch(self._batch_inputs(imgs, uniforms, xyz,
                                                         desc, valid))
                rows = res.rows.cpu().numpy()         # the one fetch
            n_inl = rows[:, 14].astype(np.int64)
            n_match = rows[:, 15].astype(np.int64)
            n_feat = rows[:, 16].astype(np.int64)
            trig = np.nonzero(rows[:, 17] > 0.5)[0]
            n_accept = int(trig[0]) if len(trig) else K
            self.batch_accepted.append(n_accept)
            for j in range(n_accept):
                self.trajectory.append(res.rows[j, :7])
                self._traj_rel.append((self.last_kf_id, res.rows[j, 7:14]))
                self.timestamps.append(batch[j].timestamp)
                self.stats.append({
                    "n_features": int(n_feat[j]), "n_matches": int(n_match[j]),
                    "n_inliers": int(n_inl[j]), "n_kf": self._n_frames_host,
                    "n_points": self._n_points_host})
            # the statistics cover the accepted frames and the trigger
            # frame: applied even when a trigger heads the batch
            a = self.arena
            self.arena = a.replace(
                point_visible=a.point_visible.index_add(0, slab_ids,
                                                        res.visible),
                point_found=a.point_found.index_add(0, slab_ids, res.found))
            if n_accept > 0:
                self.pose_wc = res.pose_wc
                self.velocity = res.velocity
                self.frames_since_kf += n_accept
                self._lost_frames = 0
            out.extend(res.rows[j, :7] for j in range(n_accept))
            i += n_accept
            if n_accept < K:
                j = n_accept
                out.append(self._handle_trigger_frame(
                    batch[j], imgs[j], res, slab_ids, bool(rows[j, 18] > 0.5),
                    int(n_inl[j]), int(n_match[j]), int(n_feat[j])))
                i += 1
        return out

    def _batch_uniforms(self, K: int) -> torch.Tensor:
        """The RANSAC uniforms of K frames, (K, 256, 4), in one draw (or
        K calls of the ``uniforms`` hook, frame by frame)."""
        if self._uniforms is not None:
            return torch.stack([self._uniforms() for _ in range(K)]).to(
                self.device)
        return torch.rand((K, RANSAC_B, 4), generator=self._gen,
                          device=self.device)

    def _batch_inputs(self, imgs, uniforms, xyz, desc, valid
                      ) -> Dict[str, torch.Tensor]:
        """The K-frame body's inputs: everything it reads, as tensors (a
        replayed graph reads nothing else, since the arena's tensors are
        replaced between batches)."""
        return dict(
            imgs=imgs, uniforms=uniforms, pose_wc=self.pose_wc,
            velocity=self.velocity,
            fs_kf=torch.full((), self.frames_since_kf, dtype=torch.int32,
                             device=self.device),
            slab_xyz=xyz, slab_desc=desc, slab_valid=valid,
            kf_pose=self.arena.frame_pose[self.last_kf_id][:7])

    def _run_batch(self, inputs: Dict[str, torch.Tensor]) -> BatchResult:
        """The K-frame body: eager on the CPU (and with ``batch_graphs``
        False); on the card, a replay of this system's graph for the
        inputs' shapes (captured on first use), its outputs copied out of
        the graph's buffers."""
        if self.device.type != "cuda" or not self.batch_graphs:
            return self._batch_body(inputs)
        key = tuple(inputs["imgs"].shape)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = BatchGraph(self._batch_body, inputs)
        return _clone(graph(inputs))

    def _batch_body(self, x: Dict[str, torch.Tensor]) -> BatchResult:
        """K frames of extract (B1, B2) -> projection under the
        constant-velocity prediction -> gated matching (B4) -> PnP RANSAC
        + GN refine against the fixed slab, with track()'s gates and
        _need_keyframe's predicate on the device.  The state stops at
        the first frame that trips either (``stopped``); that frame's
        features, matches, inliers and pose are frozen for the host.  No
        host reads, so that the card can capture it as one graph."""
        c = self.cfg
        cam = self.camera
        xyz, desc, valid = x["slab_xyz"], x["slab_desc"], x["slab_valid"]
        pose_wc, velocity, fs = x["pose_wc"], x["velocity"], x["fs_kf"]
        thr = (c.pnp_px_threshold / cam.fx) ** 2
        match = match_hamming_gated if c.use_kernels \
            else match_descriptors_gated
        stopped = torch.zeros((), dtype=torch.bool, device=xyz.device)
        visits = torch.zeros(xyz.shape[0], dtype=torch.int32,
                             device=xyz.device)
        found = torch.zeros_like(visits)
        rows, frozen = [], None
        for img, uni in zip(x["imgs"], x["uniforms"]):
            feats = extract_features(img, max_kps=c.max_kps,
                                     threshold=c.fast_threshold,
                                     use_kernels=c.use_kernels)
            pred_cw = se3_mul(velocity, se3_inverse(pose_wc))
            uv_pred, proj_ok = cam.project(se3_apply(pred_cw, xyz))
            visible = valid & proj_ok
            m = match(desc, visible, feats.desc, feats.valid, uv_pred,
                      feats.uv, c.gate_radius_px, max_dist=c.match_max_dist,
                      ratio=c.match_ratio)
            rays = cam.unproject(feats.uv[m.idx.clamp_min(0).long()])[:, :2]
            T, inl, n = find_pnp_ransac(xyz, rays, m.valid, threshold=thr,
                                        B=RANSAC_B, uniforms=uni)
            jump = torch.linalg.vector_norm(
                se3_inverse(T)[:3] - se3_inverse(pred_cw)[:3])
            ok = (n >= c.min_track_inliers) & (jump <= c.max_pose_jump)
            fs1 = fs + 1
            ref = m.count.clamp_min(1).to(torch.float32)
            need_kf = (fs1 >= c.kf_min_gap) & (
                (fs1 >= c.kf_max_gap)
                | (n.to(torch.float32) / ref < c.kf_min_inlier_frac)
                | (n < 2 * c.min_track_inliers))
            trigger = ~ok | need_kf
            accept = ~stopped & ~trigger
            first = ~stopped & trigger
            velocity = torch.where(accept, se3_mul(T, pose_wc), velocity)
            pose_wc = torch.where(accept, se3_inverse(T), pose_wc)
            fs = torch.where(accept, fs1, fs)
            # visible / found count the accepted frames and the trigger
            visits = visits + (visible & ~stopped).to(torch.int32)
            found = found + (m.valid & inl & ~stopped).to(torch.int32)
            state = (feats, m, inl, T)
            frozen = state if frozen is None else _where(first, state,
                                                         frozen)
            rows.append(torch.cat([
                pose_wc, se3_mul(x["kf_pose"], pose_wc),
                torch.stack([n.to(torch.float32), m.count.to(torch.float32),
                             feats.count.to(torch.float32),
                             first.to(torch.float32),
                             ok.to(torch.float32)])]))
            stopped = stopped | trigger
        return BatchResult(torch.stack(rows), pose_wc, velocity, visits,
                           found, *frozen)

    def _handle_trigger_frame(self, frame: FrameData, img: torch.Tensor,
                              res: BatchResult, slab_ids, ok: bool,
                              n_inliers: int, n_matches: int,
                              n_feats: int) -> torch.Tensor:
        """The frame that stopped a batch, from the state the batch froze
        (its extraction, matching and RANSAC are not run again): track()'s
        control flow after PnP, where an accepted pose needs a keyframe."""
        self._set_keypoint_samples(frame, img, res.feats)
        self._last_track = (slab_ids, res.matches, res.inliers)
        self._after_pnp(frame, res.feats, res.T, ok, ok)
        self._prev_feats = res.feats
        self._prev_frame = frame
        self._record(frame, n_feats, n_matches, n_inliers)
        return self.pose_wc

    # ------------------------------------------------------------------
    def _need_keyframe(self, n_inliers: int, n_matches: int,
                       frames_since_kf: Optional[int] = None) -> bool:
        """Keyframe promotion, at ``frames_since_kf`` (by default the
        current count) frames since the last keyframe; the batch body
        evaluates the same predicate on the device."""
        c = self.cfg
        fs = self.frames_since_kf if frames_since_kf is None \
            else frames_since_kf
        if fs < c.kf_min_gap:
            return False
        if fs >= c.kf_max_gap:
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
        return add_observations(arena, fid, pids, self._kp_range(), newok)

    def _triangulate_new_points(self, arena, fid, feats, pose_cw):
        """Mono mapping: keypoints matched (plain Hamming matcher) to the
        previous keyframe's, triangulated between the two poses, become
        points observed by both."""
        c = self.cfg
        prev = self.last_kf_id
        if prev < 0:
            return arena
        prev_valid = self._kp_range() < arena.frame_kp_count[prev]
        m = match_descriptors(arena.frame_desc[prev], prev_valid, feats.desc,
                              feats.valid)
        kp = m.idx.clamp_min(0).long()
        rays1 = self.camera.unproject(arena.frame_kp_uv[prev])[:, :2]
        rays2 = self.camera.unproject(feats.uv[kp])[:, :2]
        X, d1 = triangulate(arena.frame_pose[prev][:7], pose_cw, rays1, rays2)
        d2 = se3_apply(pose_cw, X)[:, 2]
        good = m.valid & (d1 > 0.05) & (d2 > 0.05) & (d1 < 1e3)
        arena, pids = insert_points(arena, X, feats.desc[kp], good,
                                    ref_frame=fid)
        arena = add_observations(arena, prev, pids, self._kp_range(), good)
        return add_observations(arena, fid, pids, kp, good)

    def _insert_keyframe(self, frame: FrameData, feats: Features, pose_cw,
                         run_ba: bool = True) -> None:
        """Frame write; for a tracked frame, the fuse of its tracked
        observations; new points from depth away from existing ones, or,
        without depth, triangulated against the previous keyframe.

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
            self._emit_imu_factor(fid)
            matched = torch.zeros(c.max_kps, dtype=torch.bool,
                                  device=self.device)
            if tracked:
                slab_ids, m, inl = self._last_track
                self.arena, matched = self._fuse_tracked(
                    self.arena, fid, pose_cw, feats, slab_ids, m, inl)
            d = self._cur_kp_depth
            if d is not None:
                newok = (feats.valid & ~matched & (d > 1e-3)
                         & torch.isfinite(d))
                if self.initialized:
                    newok = newok & ~self._near_existing(
                        self.arena, self._kf_tensor(), pose_cw, feats.uv)
                self.arena = self._new_points(self.arena, fid, pose_cw,
                                              feats, newok)
            elif self.initialized:
                self.arena = self._triangulate_new_points(self.arena, fid,
                                                          feats, pose_cw)
        self._finish_keyframe(fid, run_ba)

    def _emit_imu_factor(self, fid: int) -> None:
        """The factor composed since the last keyframe, as the
        (last, fid) factor for VI BA and the (fid, last) rotation edge for
        the loop pose graph; the velocity of ``fid`` predicted from it."""
        if self._imu_acc is not None and self.last_kf_id >= 0:
            last = self.last_kf_id
            fac = _factor_to_numpy(self._imu_acc)
            self.imu_edges.append((fid, last, fac.dq))
            self.imu_factors.append((last, fid, fac))
            self._imu_factor_idx[(last, fid)] = fac
            self._predict_kf_velocity(last, fid, fac)
        self._imu_acc = None

    def _finish_keyframe(self, fid: int, run_ba: bool) -> None:
        """After inserting keyframe ``fid``: VI initialization, local BA,
        loop closing, then map hygiene."""
        self.last_kf_id = fid
        self.frames_since_kf = 0
        self._maybe_vi_init()
        if run_ba and self.cfg.enable_ba and self._n_frames_host >= 2:
            self._local_ba()
        if self.loop_closer is not None:
            with self.timer.section("slam/loop"):
                self._bow_add(fid)
                self.arena, closed = self.loop_closer.close(
                    self.arena, self.camera, fid, imu_edges=self.imu_edges,
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

    # -- visual-inertial state ---------------------------------------------
    def _predict_kf_velocity(self, i: int, j: int, factor: ImuFactor) -> None:
        """Seed keyframe j's world velocity from i's and the IMU factor."""
        if not self.vi_ready or i not in self.kf_vel:
            return
        pose_cw_i = self.arena.frame_pose[i, :7].cpu()
        R_wb = quat_to_matrix(pose_cw_i[3:7]).numpy().T
        dt = float(factor.dt)
        self.kf_vel[j] = (self.kf_vel[i] + self.gravity_w * dt
                          + R_wb @ factor.dv).astype(np.float32)

    def _maybe_vi_init(self) -> None:
        """Visual-inertial alignment once ``vi_min_factors`` inter-keyframe
        factors exist: linear gravity / velocity (+ mono scale)
        estimation on the host; gravity is then refined by the joint VI
        BA."""
        c = self.cfg
        if (self.vi_ready or not c.enable_vi_ba
                or len(self.imu_factors) < c.vi_min_factors):
            return
        kf_ids = sorted({i for i, _, _ in self.imu_factors}
                        | {j for _, j, _ in self.imu_factors})
        id2loc = {f: k for k, f in enumerate(kf_ids)}
        poses = self.arena.frame_pose[torch.tensor(kf_ids,
                                                   device=self.device), :7]
        pair_i = np.asarray([id2loc[i] for i, _, _ in self.imu_factors])
        pair_j = np.asarray([id2loc[j] for _, j, _ in self.imu_factors])
        imu = stack_factors([f for _, _, f in self.imu_factors], "cpu")
        mono = self._cur_kp_depth is None
        g, vel, s = estimate_gravity_velocity(poses, pair_i, pair_j, imu,
                                              with_scale=mono)
        if not np.isfinite(g).all() or not np.isfinite(vel).all():
            return
        if mono and (not np.isfinite(s) or not 0.05 < s < 50.0):
            return  # degenerate alignment; retry with more factors later
        if mono and abs(s - 1.0) > 1e-3:
            self._apply_map_scale(float(s))  # velocities are metric already
        self.gravity_w = g.astype(np.float32)
        for k, f in enumerate(kf_ids):
            self.kf_vel[f] = vel[k].astype(np.float32)
        self.vi_ready = True

    def _apply_map_scale(self, s: float) -> None:
        """Rescale the vision world to metric (mono VI alignment), and the
        trajectory recorded so far with it."""
        a = self.arena
        fp = a.frame_pose.clone()
        fp[:, :3] = fp[:, :3] * s
        self.arena = a.replace(frame_pose=fp, point_xyz=a.point_xyz * s,
                               frame_kp_depth=a.frame_kp_depth * s)
        scale = torch.tensor([s, s, s, 1.0, 1.0, 1.0, 1.0],
                             device=self.device)
        self.pose_wc = self.pose_wc * scale
        self.velocity = self.velocity * scale
        self.trajectory = [p * scale for p in self.trajectory]

    # ------------------------------------------------------------------
    def _local_ba_window(self, arena: MapArena, kf: torch.Tensor):
        """The covisibility window of ``kf``: (cam_ids, point_ids, BA
        problem), the oldest keyframe and keyframe 0 fixed."""
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
        return cam_ids, point_ids, problem

    def _local_ba(self) -> None:
        """Local BA over the last keyframe's window, written back; the
        joint VI LM once VI is initialized.  The B5 / B6 kernels run when
        ``resolve_ba_kernels`` allows (at most 32 cameras), the plain
        Schur path above that."""
        c = self.cfg
        with self.timer.section("slam/local_ba"):
            kf = self._kf_tensor()
            cam_ids, point_ids, problem = self._local_ba_window(self.arena,
                                                                kf)
            kernels = resolve_ba_kernels(c.use_kernels, cam_ids.shape[0])
            if self.vi_ready and c.enable_vi_ba:
                with self.timer.section("slam/vi_local_ba"):
                    problem = self._vi_local_ba(problem, cam_ids, kernels)
            else:
                problem, _ = bundle_adjust(problem, iters=c.ba_iters,
                                           use_kernels=kernels)
            self.arena = write_back_to_arena(self.arena, problem, cam_ids,
                                             point_ids)
            self.pose_wc = se3_inverse(self.arena.frame_pose[kf.long()][:7])
            self.timer.block(self.pose_wc)

    def _vi_local_ba(self, problem, cam_ids: torch.Tensor,
                     use_kernels: bool):
        """Joint visual-inertial LM over the window: the IMU factors whose
        endpoints both lie in it couple poses, velocities and biases; the
        factor slots are padded to ``ba_window`` with inert identity
        factors.  Reads the window's ids (one fetch) and the velocities,
        biases and gravity after (one fetch)."""
        c = self.cfg
        dev = self.device
        cam_list = cam_ids.tolist()
        loc = {f: k for k, f in enumerate(cam_list) if f >= 0}
        K = c.ba_window
        pi = np.full(K, -1, np.int32)
        pj = np.full(K, -1, np.int32)
        pv = np.zeros(K, bool)
        facs = []
        # factors exist only between temporally consecutive keyframes: look
        # each in-window ordered pair up in the index
        for i in sorted(loc):
            for j in sorted(loc):
                f = self._imu_factor_idx.get((i, j))
                if f is not None and len(facs) < K:
                    k = len(facs)
                    pi[k], pj[k], pv[k] = loc[i], loc[j], True
                    facs.append(f)
        facs += [_PAD_FACTOR] * (K - len(facs))
        vel = np.stack([self.kf_vel.get(f, np.zeros(3, np.float32))
                        for f in cam_list])
        state = torch.from_numpy(np.concatenate([
            vel.reshape(-1), self.gravity_w, self.bias_g,
            self.bias_a]).astype(np.float32)).to(dev)
        n = vel.size
        vip = ViProblem(
            vision=problem, vel=state[:n].reshape(-1, 3),
            pair_i=torch.from_numpy(pi).to(dev),
            pair_j=torch.from_numpy(pj).to(dev),
            pair_valid=torch.from_numpy(pv).to(dev),
            imu=stack_factors(facs, dev), gravity_w=state[n:n + 3],
            bias_g=state[n + 3:n + 6], bias_a=state[n + 6:n + 9])
        out, self.vi_costs = vi_bundle_adjust(
            vip, iters=c.vi_ba_iters, refine_gravity=True,
            use_kernels=use_kernels)
        got = torch.cat([out.vel.reshape(-1), out.bias_g, out.bias_a,
                         out.gravity_w]).cpu().numpy()
        out_vel = got[:n].reshape(-1, 3)
        for f, k in loc.items():
            self.kf_vel[f] = out_vel[k]
        self.bias_g = got[n:n + 3]
        self.bias_a = got[n + 3:n + 6]
        self.gravity_w = got[n + 6:n + 9]
        return out.vision

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


@SLAMS.register("keyframe")
def _make_keyframe_slam(camera: Camera, device="cuda",
                        **kw) -> KeyframeSLAM:
    """``SLAMS.create("keyframe", camera, device=..., **SLAMConfig
    fields)``; a ``vocabulary`` enables loop closure."""
    voc = kw.pop("vocabulary", None)
    cfg = SLAMConfig(**kw) if kw else None
    return KeyframeSLAM(camera, cfg, vocabulary=voc, device=device)
