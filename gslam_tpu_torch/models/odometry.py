"""Frame-to-frame visual odometry: the smallest end-to-end system.

Counterpart of ``gslam_tpu/models/odometry.py`` (BASELINE config #1,
"monocular feature detect + match + PnP odometry").  Per frame: extract
(FAST + NMS (B1), BRIEF (B2)) -> match against the previous frame (the
all-pairs Hamming matcher, B3) -> pose:

* depth mode (RGB-D, synthetic or stereo-derived depth): the previous
  frame's matched keypoints, lifted to 3D with its depth, give the
  current pose by PnP RANSAC + GN refine, at metric scale;
* mono mode: two-view H / E geometry with cheirality decomposition; the
  translation is scaled to ``scale_hint`` per step, so the trajectory is
  up to scale (judge it by ATE after Sim3 alignment).

The host chains the poses and reads the match and inlier counts, where
the JAX package does.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.se3 import se3_identity, se3_inverse, se3_mul
from gslam_tpu_torch.datasets.base import FrameData
from gslam_tpu_torch.estimation.init2view import (
    two_view_draws, two_view_geometry,
)
from gslam_tpu_torch.estimation.pnp import find_pnp_ransac
from gslam_tpu_torch.ops.cuda.matcher import match_hamming
from gslam_tpu_torch.ops.frontend import Features, extract_features
from gslam_tpu_torch.ops.matching import match_descriptors
from gslam_tpu_torch.utils.platform import require_device
from gslam_tpu_torch.utils.timer import Timer

RANSAC_B = 256          # hypotheses per RANSAC call
MIN_MATCHES = 12        # matches before a pose is tried
MIN_INLIERS = 10        # inliers to accept it
PNP_THRESHOLD = 2e-5    # squared normalized reprojection error


class FrameToFrameOdometry:
    """``FrameToFrameOdometry(camera, ...).track(frame)`` per frame;
    returns the cam->world pose (7,) on the device.

    Runs on ``device`` (the CUDA card unless the caller asks for the
    CPU).  ``use_kernels`` routes B1, B2 and B3 through the CUDA
    kernels (their plain versions on CPU tensors).  RANSAC draws come
    from a ``torch.Generator`` seeded with ``seed``, or, when
    ``uniforms`` is given, from ``uniforms()``: a (256, 4) PnP draw in
    depth mode, the two-view pair ((256, 8), (256, 4)) in mono mode (the
    tests replay the JAX package's key chain through it)."""

    def __init__(self, camera: Camera, max_kps: int = 512,
                 fast_threshold: float = 0.06, scale_hint: float = 0.1,
                 seed: int = 0, use_kernels: bool = True, device="cuda",
                 uniforms: Optional[Callable[[], object]] = None):
        self.device = require_device(device)
        self.camera = camera
        self.max_kps = max_kps
        self.fast_threshold = fast_threshold
        self.scale_hint = scale_hint
        self.use_kernels = use_kernels
        self.timer = Timer()
        self._uniforms = uniforms
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.prev: Optional[Features] = None
        self.prev_depth: Optional[torch.Tensor] = None
        self.pose_wc = se3_identity(device=self.device)  # last cam->world
        self.trajectory: List[torch.Tensor] = []
        self.timestamps: List[float] = []
        self.stats: List[dict] = []

    def track(self, frame: FrameData) -> torch.Tensor:
        self.timer.frame = frame.id
        img = torch.as_tensor(frame.image, device=self.device)
        with self.timer.section("odom/extract"):
            feats = extract_features(img, max_kps=self.max_kps,
                                     threshold=self.fast_threshold,
                                     use_kernels=self.use_kernels)
        n_matches = 0
        n_inliers = 0
        if self.prev is not None:
            match = match_hamming if self.use_kernels else match_descriptors
            with self.timer.section("odom/match"):
                m = match(self.prev.desc, self.prev.valid, feats.desc,
                          feats.valid)
            n_matches = int(m.count)
            if n_matches >= MIN_MATCHES:
                rel = self._relative_pose(m, feats)
                if rel is not None:
                    # T_rel: prev_cam -> cur_cam; chain cam->world
                    T_rel, n_inliers = rel
                    self.pose_wc = se3_mul(self.pose_wc,
                                           se3_inverse(T_rel))
        self.prev = feats
        self.prev_depth = None if frame.depth is None else \
            torch.as_tensor(frame.depth, device=self.device)
        self.trajectory.append(self.pose_wc)
        self.timestamps.append(frame.timestamp)
        self.stats.append({"n_features": int(feats.count),
                           "n_matches": n_matches,
                           "n_inliers": n_inliers})
        return self.pose_wc

    def _relative_pose(self, m, feats: Features):
        """Matched prev -> cur: (T prev_cam -> cur_cam, inliers), or None
        with too few inliers."""
        cam = self.camera
        uv_prev = self.prev.uv
        uv_cur = feats.uv[m.idx.clamp_min(0).long()]
        rays_cur = cam.unproject(uv_cur)[:, :2]
        if self.prev_depth is not None:
            # PnP with metric depth from the previous frame
            D = self.prev_depth
            xi = uv_prev[:, 0].to(torch.int32).clamp(0, D.shape[1] - 1)
            yi = uv_prev[:, 1].to(torch.int32).clamp(0, D.shape[0] - 1)
            d = D[yi.long(), xi.long()]
            ok = m.valid & (d > 1e-3) & torch.isfinite(d)
            rays3 = cam.unproject(uv_prev)
            pts3 = rays3 / rays3[:, 2:3] * d[:, None]    # prev cam frame
            draw = dict(generator=self._gen) if self._uniforms is None \
                else dict(uniforms=self._uniforms())
            with self.timer.section("odom/pnp"):
                T, _, n = find_pnp_ransac(pts3, rays_cur, ok,
                                          threshold=PNP_THRESHOLD,
                                          B=RANSAC_B, **draw)
            n = int(n)
            return (T, n) if n >= MIN_INLIERS else None
        # mono: two-view geometry with H / E model selection (planar-safe)
        rays_prev = cam.unproject(uv_prev)[:, :2]
        draws = self._uniforms() if self._uniforms is not None else \
            two_view_draws(RANSAC_B, self._gen, self.device)
        with self.timer.section("odom/essential"):
            tv = two_view_geometry(rays_prev, rays_cur, m.valid,
                                   sigma=1.0 / float(cam.fx), B=RANSAC_B,
                                   uniforms=draws)
        n = int(tv.n_inliers)
        if n < MIN_INLIERS:
            return None
        t = tv.T_21[:3]
        t = t / torch.linalg.vector_norm(t).clamp_min(1e-9) * self.scale_hint
        return torch.cat([t, tv.T_21[3:]]), n

    # -- evaluation helpers -------------------------------------------------
    def positions(self) -> np.ndarray:
        """(N, 3) camera centres, one fetch."""
        if not self.trajectory:
            return np.zeros((0, 3))
        return torch.stack(self.trajectory)[:, :3].cpu().numpy()


@SLAMS.register("odometry")
def _make_odometry(camera: Camera, **kw) -> FrameToFrameOdometry:
    kw.pop("vocabulary", None)      # no BoW stage
    return FrameToFrameOdometry(camera, **kw)
