"""Direct (photometric) odometry: the SVO / DSO family analog.

Counterpart of ``gslam_tpu/models/direct.py``.  A keyframe contributes a
fixed slab of ``n_points`` high-gradient pixels with valid depth (one
top-k over the gradient image), lifted once to keyframe-camera points,
with their reference intensities sampled per pyramid level.  A frame is
tracked coarse to fine: per level ``gn_iters`` Gauss-Newton steps warp
the slab with the current SE(3), sample intensity and gradient
bilinearly, and solve Huber-weighted 6x6 normal equations, with a
left-multiplicative update.  With frame depth (``use_depth_residual``)
the geometric residual z_warp - D_cur(u, v) joins the photometric one
(DVO-style), which constrains the motion where the image has no texture.

The reference's ``lax.scan`` over GN steps is a Python loop here; the
arithmetic is the reference's.  Plain PyTorch throughout, as the
reference is plain jnp (no Pallas kernel).  On the card a frame's
alignment, from the motion model's guess through every level's
gradients, depth resize and GN steps to the tracked state, is the
replay of one CUDA graph, captured once a process for its shapes and
parameters, the counterpart of the reference's jitted step.  The host
reads the final level's valid fraction and photometric error once a
frame, where the JAX package does.

``finest_level`` (DVO's ``LastLevel``) ends the coarse-to-fine loop
above the full image: levels ``n_levels - 1`` down to it are aligned, and
the pose, the valid fraction and the error are the finest aligned
level's.  The keyframe slab is still selected on level 0.  The JAX
package has no such field: at 0, the default, the loop ends at the full
image as the JAX package's does.

Spans: ``direct/pyramid``, ``direct/align`` (the motion model's guess,
all levels, the tracked state and the fetch; ``direct/align/capture``
where it captures the graph), ``direct/align/fetch`` (the one fetch: the
host waiting for the card) and ``direct/keyframe`` (selection, lifting
and the per-level reference samples).  Counters, one observation a frame that was aligned, from the
fetch: ``direct/inbounds`` (in-bounds points at the finest aligned
level), ``direct/points`` (valid slab points), ``direct/keyframes`` (1
where the frame made a keyframe) and ``direct/lost`` (1 where it
coasted).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.se3 import (
    se3_apply, se3_exp, se3_identity, se3_inverse, se3_mul,
)
from gslam_tpu_torch.datasets.base import FrameData
from gslam_tpu_torch.ops.cuda import graphs
from gslam_tpu_torch.ops.frontend import (
    _bilinear, _topk_stable, gaussian_blur, image_pyramid,
)
from gslam_tpu_torch.opt.robust import huber_weight
from gslam_tpu_torch.utils.platform import require_device
from gslam_tpu_torch.utils.timer import Timer


@dataclasses.dataclass
class DirectConfig:
    n_points: int = 1024       # tracked high-gradient pixels
    n_levels: int = 3
    scale: float = 2.0
    finest_level: int = 0      # last level aligned (DVO's LastLevel)
    gn_iters: int = 12         # per level
    blur_sigma: float = 1.2
    huber_delta: float = 0.08  # intensity units ([0,1] images)
    min_depth: float = 0.05
    max_depth: float = 1e3
    kf_overlap: float = 0.6    # new keyframe below this valid fraction
    kf_max_gap: int = 8
    min_valid_frac: float = 0.25  # below: tracking lost, coast
    # RGB-D dense mode: add the geometric residual z_warp - D_cur(u,v)
    # (DVO-style photometric + geometric) when frames carry depth.
    use_depth_residual: bool = True
    depth_weight: float = 10.0   # lambda: (sigma_I / sigma_D)^2
    huber_depth: float = 0.10    # meters

    @property
    def min_track_inliers(self) -> int:
        """The fewest ``stats["n_inliers"]`` of a frame that was tracked
        (not coasted): ``min_valid_frac`` of the slab."""
        return math.ceil(self.min_valid_frac * self.n_points)


def _gradients(img: torch.Tensor):
    """Central differences, zero on the border rows / columns."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = (img[:, 2:] - img[:, :-2]) * 0.5
    gy[1:-1, :] = (img[2:, :] - img[:-2, :]) * 0.5
    return gx, gy


def _level_intrinsics(cam: Camera, shape, base_shape):
    """Pixel-centre-correct intrinsics for a resized level."""
    sy = shape[0] / base_shape[0]
    sx = shape[1] / base_shape[1]
    return (cam.fx * sx, cam.fy * sy,
            (cam.cx + 0.5) * sx - 0.5, (cam.cy + 0.5) * sy - 0.5)


def _resize_nearest(depth: torch.Tensor, shape) -> torch.Tensor:
    """Nearest resize with half-pixel centres, as ``jax.image.resize(...,
    "nearest")`` (``mode="nearest"`` picks other source pixels)."""
    return F.interpolate(depth[None, None], size=tuple(shape),
                         mode="nearest-exact")[0, 0]


def _solve_or_nan(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H^-1 b; NaN where H is singular (``jnp.linalg.solve`` returns
    non-finite values there, ``torch.linalg.solve`` would raise), with
    no host read."""
    x, info = torch.linalg.solve_ex(H, b)
    return torch.where(info == 0, x, x.new_full((), float("nan")))


def _align_level(img, gx, gy, X, I_ref, valid, T_init, iters, fx, fy, cx,
                 cy, huber, depth=None, dgx=None, dgy=None,
                 depth_weight: float = 0.0, huber_d: float = 0.1,
                 use_depth: bool = False):
    """GN alignment of the point slab X (keyframe-camera coordinates) to
    one pyramid level: the photometric residual I_cur(warp) - I_ref,
    plus (RGB-D dense mode) the geometric residual z_warp - D_cur(warp)
    with the analytic Jacobian dz/dxi - grad(D) . d(u, v)/dxi.  Returns
    (T_ck, valid fraction, mean absolute photometric residual), 0-d
    tensors on the device."""
    H, W = img.shape

    def residual_system(T):
        pc = se3_apply(T, X)
        x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
        front = z > 1e-3
        iz = 1.0 / torch.where(front, z, torch.ones_like(z))
        u = fx * x * iz + cx
        v = fy * y * iz + cy
        inb = (front & valid & (u >= 1.0) & (u <= W - 2.0)
               & (v >= 1.0) & (v <= H - 2.0))
        Ic = _bilinear(img, u, v)
        gu = _bilinear(gx, u, v)
        gv = _bilinear(gy, u, v)
        r = Ic - I_ref
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        Ju = fx * torch.stack([iz, zero, -x * iz2, -x * y * iz2,
                               1.0 + x * x * iz2, -y * iz], -1)
        Jv = fy * torch.stack([zero, iz, -y * iz2, -(1.0 + y * y * iz2),
                               x * y * iz2, x * iz], -1)
        J = gu[:, None] * Ju + gv[:, None] * Jv          # (K, 6)
        w = huber_weight(r.abs(), huber) * inb
        out = [(r, J, w)]
        if use_depth:
            # nearest sampling: bilinear across a depth discontinuity
            # invents surfaces; discontinuities and gross disagreements
            # are gated out
            ui = torch.round(u).to(torch.int32).clamp(0, W - 1).long()
            vi = torch.round(v).to(torch.int32).clamp(0, H - 1).long()
            Dc = depth[vi, ui]
            du = dgx[vi, ui]
            dv_ = dgy[vi, ui]
            r_d = z - Dc
            d_ok = (inb & (Dc > 1e-3) & torch.isfinite(Dc)
                    & torch.isfinite(du) & torch.isfinite(dv_)
                    & (du * du + dv_ * dv_ < 0.25) & (r_d.abs() < 0.5))
            # gated values are scrubbed, not only zero-weighted: a NaN
            # depth would poison the normal equations through NaN * 0
            r_d = torch.where(d_ok, r_d, zero)
            du = torch.where(d_ok, du, zero)
            dv_ = torch.where(d_ok, dv_, zero)
            # dz/dxi (left twist): [0, 0, 1, y, -x, 0]
            Jz = torch.stack([zero, zero, torch.ones_like(x), y, -x, zero],
                             -1)
            J_d = Jz - du[:, None] * Ju - dv_[:, None] * Jv
            w_d = depth_weight * huber_weight(r_d.abs(), huber_d) * d_ok
            out.append((r_d, J_d, w_d))
        return out, inb

    eye = 1e-6 * torch.eye(6, device=X.device)
    T = T_init
    for _ in range(iters):
        terms, _ = residual_system(T)
        Hm = eye
        b = torch.zeros(6, device=X.device)
        for r, J, w in terms:
            Jw = J * w[:, None]
            Hm = Hm + Jw.T @ J
            b = b + Jw.T @ r
        dx = -_solve_or_nan(Hm, b)
        T = se3_mul(se3_exp(dx), T)
    terms, inb = residual_system(T)
    r = terms[0][0]
    n = inb.sum().clamp_min(1)
    frac = inb.sum() / valid.sum().clamp_min(1)
    err = torch.sum(torch.where(inb, r.abs(), torch.zeros_like(r))) / n
    return T, frac, err


class _Aligned(NamedTuple):
    """What a frame's alignment leaves on the device: ``scalars`` (3,)
    float32 holds the finest level's valid fraction and photometric
    error and the slab's valid count, for the one fetch; ``pose_wc`` and
    ``velocity`` are the state where the frame counts as tracked."""
    scalars: torch.Tensor
    pose_wc: torch.Tensor
    velocity: torch.Tensor


def _align_body(levels, gn_iters, huber, depth_weight, huber_d, inputs
                ) -> _Aligned:
    """One frame's alignment, coarse to fine, from the constant-velocity
    guess: ``levels`` holds (level, its intrinsics) from the coarsest
    down to the finest aligned level; ``inputs`` the state ``pose_wc``,
    ``velocity`` and ``kf_pose_cw``, the slab ``X`` / ``valid`` / ``count``
    with its reference samples ``ref<level>``, the frame's
    ``level<level>`` images and, for the geometric residual, its
    full-size ``depth``."""
    pose_wc, kf_pose_cw = inputs["pose_wc"], inputs["kf_pose_cw"]
    # init: constant velocity in the current-camera chain
    # T_c(t-1)<-kf = T_c(t-1)<-w o T_w<-kf
    T_ck_prev = se3_mul(se3_inverse(pose_wc), se3_inverse(kf_pose_cw))
    T = se3_mul(inputs["velocity"], T_ck_prev)
    depth = inputs.get("depth")
    for li, (fxl, fyl, cxl, cyl) in levels:
        lvl = inputs[f"level{li}"]
        gx, gy = _gradients(lvl)
        dl = dgx = dgy = None
        if depth is not None:
            # nearest resize: bilinear would blur depth discontinuities
            # into phantom surfaces
            dl = _resize_nearest(depth, lvl.shape)
            dgx, dgy = _gradients(dl)
        T, fr, er = _align_level(
            lvl, gx, gy, inputs["X"], inputs[f"ref{li}"], inputs["valid"],
            T, gn_iters, fxl, fyl, cxl, cyl, huber, depth=dl, dgx=dgx,
            dgy=dgy, depth_weight=depth_weight, huber_d=huber_d,
            use_depth=depth is not None)
    pose_cw = se3_mul(T, kf_pose_cw)
    return _Aligned(
        torch.stack([fr.to(torch.float32), er,
                     inputs["count"].to(torch.float32)]),
        se3_inverse(pose_cw), se3_mul(pose_cw, pose_wc))


def _select_points(img, depth, n_points, min_depth, max_depth, fx, fy, cx,
                   cy):
    """Top-K gradient pixels with valid depth -> (X_kf (K, 3), valid):
    ties go to the lowest pixel index, as ``lax.top_k``'s."""
    gx, gy = _gradients(img)
    mag = gx * gx + gy * gy
    H, W = img.shape
    dok = (depth > min_depth) & (depth < max_depth) & torch.isfinite(depth)
    # keep away from the border so bilinear gathers stay in bounds
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    edge = (xx >= 2) & (xx < W - 2) & (yy >= 2) & (yy < H - 2)
    score = torch.where(dok & edge, mag, mag.new_full((), -1.0)).reshape(-1)
    val, idx = _topk_stable(score, n_points)
    u = (idx % W).to(torch.float32)
    v = (idx // W).to(torch.float32)
    z = depth.reshape(-1)[idx]
    X = torch.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    return X, val > 0.0


class DirectOdometry:
    """``DirectOdometry(camera, DirectConfig(...)).track(frame)`` per
    frame; returns the cam->world pose (7,) on the device.  Runs on
    ``device`` (the CUDA card unless the caller asks for the CPU)."""

    def __init__(self, camera: Camera,
                 config: Optional[DirectConfig] = None, device="cuda"):
        self.device = require_device(device)
        self.camera = camera
        self.cfg = config or DirectConfig()
        if not 0 <= self.cfg.finest_level < self.cfg.n_levels:
            raise ValueError(
                f"finest_level {self.cfg.finest_level} is not a level of "
                f"the {self.cfg.n_levels}-level pyramid")
        self.timer = Timer()
        self.pose_wc = se3_identity(device=self.device)
        self.velocity = se3_identity(device=self.device)  # T_c(t)<-c(t-1)
        self.kf_pose_cw: Optional[torch.Tensor] = None  # current keyframe
        self.kf_X: Optional[torch.Tensor] = None        # (K, 3) kf-cam
        self.kf_valid: Optional[torch.Tensor] = None
        self.kf_count: Optional[torch.Tensor] = None    # valid points
        self.kf_refs: List[torch.Tensor] = []  # per-level intensities
        self.kf_shapes: List[tuple] = []
        self.frames_since_kf = 0
        self.trajectory: List[torch.Tensor] = []
        self.timestamps: List[float] = []
        self.stats: List[dict] = []
        # False: the alignment runs eagerly on the card too, the
        # counterpart of jax_disable_jit
        self.use_graphs = True

    def valid(self) -> bool:
        return True

    # ------------------------------------------------------------------
    def _pyramid(self, image: torch.Tensor) -> list:
        img = gaussian_blur(image, sigma=self.cfg.blur_sigma, radius=3)
        return image_pyramid(img, n_levels=self.cfg.n_levels,
                             scale=self.cfg.scale)

    def _make_keyframe(self, depth: Optional[torch.Tensor], pyr) -> bool:
        c = self.cfg
        if depth is None:
            return False
        cam = self.camera
        with self.timer.section("direct/keyframe"):
            base = tuple(pyr[0].shape)
            X, ok = _select_points(pyr[0], depth, c.n_points, c.min_depth,
                                   c.max_depth, cam.fx, cam.fy, cam.cx,
                                   cam.cy)
            self.kf_X, self.kf_valid = X, ok
            self.kf_count = ok.sum()
            self.kf_refs = []
            self.kf_shapes = []
            for lvl in pyr:
                fxl, fyl, cxl, cyl = _level_intrinsics(
                    cam, tuple(lvl.shape), base)
                z = X[:, 2]
                u = fxl * X[:, 0] / z + cxl
                v = fyl * X[:, 1] / z + cyl
                self.kf_refs.append(_bilinear(lvl, u, v))
                self.kf_shapes.append(tuple(lvl.shape))
            self.kf_pose_cw = se3_inverse(self.pose_wc)
        self.frames_since_kf = 0
        return True

    def _align(self, pyr, depth: Optional[torch.Tensor]) -> _Aligned:
        """The frame's alignment against the keyframe, the geometric
        residual joining where ``depth`` is given: :func:`_align_body` by
        :func:`~gslam_tpu_torch.ops.cuda.graphs.run` over the process's
        graph for the inputs' shapes and the parameters, so that a
        frame's ~13,500 operations at DVO's sizes are one launch on the
        card (span ``direct/align/capture`` on a miss)."""
        c = self.cfg
        base = self.kf_shapes[0]
        aligned = range(len(pyr) - 1, c.finest_level - 1, -1)
        levels = tuple((li, _level_intrinsics(self.camera,
                                              tuple(pyr[li].shape), base))
                       for li in aligned)
        inputs = dict(pose_wc=self.pose_wc, velocity=self.velocity,
                      kf_pose_cw=self.kf_pose_cw, X=self.kf_X,
                      valid=self.kf_valid, count=self.kf_count)
        for li in aligned:
            inputs[f"level{li}"] = pyr[li]
            inputs[f"ref{li}"] = self.kf_refs[li]
        if depth is not None:
            inputs["depth"] = depth
        params = (levels, c.gn_iters, c.huber_delta, c.depth_weight,
                  c.huber_depth)
        key = ("direct", self.device, *params,
               *((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))
        return graphs.run(
            graphs.PROCESS, key, functools.partial(_align_body, *params),
            inputs, enabled=self.use_graphs, timer=self.timer,
            span="direct/align")

    # ------------------------------------------------------------------
    def track(self, frame: FrameData) -> torch.Tensor:
        c = self.cfg
        self.timer.frame = frame.id
        depth = None if frame.depth is None else \
            torch.as_tensor(frame.depth, device=self.device)
        with self.timer.section("direct/pyramid"):
            pyr = self._pyramid(torch.as_tensor(frame.image,
                                                device=self.device))

        frac = 0.0
        err = 0.0
        n_inliers = 0
        if self.kf_X is None:
            self._make_keyframe(depth, pyr)
        else:
            use_d = c.use_depth_residual and depth is not None
            with self.timer.section("direct/align"):
                out = self._align(pyr, depth if use_d else None)
                with self.timer.section("direct/align/fetch"):
                    frac, err, points = out.scalars.tolist()
            tracked = frac >= c.min_valid_frac
            made = not tracked
            if tracked:
                self.pose_wc, self.velocity = out.pose_wc, out.velocity
                self.frames_since_kf += 1
                if (frac < c.kf_overlap
                        or self.frames_since_kf >= c.kf_max_gap):
                    made = self._make_keyframe(depth, pyr)
            else:
                # lost: coast on the motion model, re-anchor
                self.pose_wc = se3_inverse(se3_mul(
                    self.velocity, se3_inverse(self.pose_wc)))
                made = self._make_keyframe(depth, pyr)
            # frac is a float32 quotient of two counts under 2^24, so this
            # recovers the in-bounds count exactly
            self.timer.count("direct/inbounds", round(frac * points))
            self.timer.count("direct/points", int(points))
            self.timer.count("direct/keyframes", int(made))
            self.timer.count("direct/lost", int(not tracked))
            n_inliers = int(frac * c.n_points)
            # the rounding kept on the side of this frame's decision, so
            # that n_inliers < min_track_inliers exactly where it coasted
            floor = c.min_track_inliers
            n_inliers = max(n_inliers, floor) if tracked else \
                min(n_inliers, floor - 1)

        self.trajectory.append(self.pose_wc)
        self.timestamps.append(frame.timestamp)
        self.stats.append({"n_features": int(c.n_points),
                           "n_matches": int(frac * c.n_points),
                           "n_inliers": n_inliers,
                           "photo_err": err})
        return self.pose_wc

    def positions(self) -> np.ndarray:
        """(N, 3) camera centres, one fetch."""
        if not self.trajectory:
            return np.zeros((0, 3))
        return torch.stack(self.trajectory)[:, :3].cpu().numpy()


@SLAMS.register("direct")
def _make_direct(camera: Camera, device="cuda", **kw) -> DirectOdometry:
    kw.pop("vocabulary", None)  # direct method: no BoW stage
    kw = {k: v for k, v in kw.items()
          if k in DirectConfig.__dataclass_fields__}
    cfg = DirectConfig(**kw) if kw else None
    return DirectOdometry(camera, cfg, device=device)
