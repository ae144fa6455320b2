"""A plain reference of the port's direct RGB-D odometry: PyTorch, float64,
one frame at a time, loops over levels and steps.

It follows the semantics that ``gslam_tpu_torch/models/direct.py``
documents for ``DirectOdometry`` under a configuration's ``slam`` table
(``DirectConfig``'s fields), each rule written out here from that
description:

- the image is blurred by a normalised Gaussian of ``blur_sigma`` over
  taps -3..3, zero outside the image, rows then columns;
- level i of the pyramid is the blurred image resized to
  (round(H / scale^i), round(W / scale^i)) by an antialiased linear
  filter: output pixel o of an axis takes input pixels j with the weight
  max(0, 1 - |j + 1/2 - s (o + 1/2)| / s), s = input / output size,
  normalised over the pixels inside the image (at s = 2 the taps
  [1, 3, 3, 1] / 8, renormalised at the border);
- a level's intrinsics are fx sx, fy sy, (cx + 1/2) sx - 1/2,
  (cy + 1/2) sy - 1/2 with s the level's size over the full image's;
- gradients are central differences (half the difference of the two
  neighbours), zero on the first and last rows and columns;
- a keyframe selects, on the blurred full image, the ``n_points``
  pixels of largest squared gradient among those with ``min_depth`` <
  depth < ``max_depth`` (finite) at least 2 pixels from every border,
  ties to the lowest row-major index; a selected pixel is valid where
  its squared gradient is above 0 (a pixel that failed the depth or
  border rule scores -1).  It lifts each to the keyframe camera by its
  depth and samples each level's intensity at the point's projection;
- a sample is bilinear with the top-left neighbour clamped into
  [0, W - 2] x [0, H - 2] and the fractions into [0, 1]; a depth sample
  is the nearest pixel (halves to even), clamped into the image, of the
  level's depth map, itself a nearest resize that takes input pixel
  floor(s (o + 1/2));
- a Gauss-Newton step warps the slab by the current keyframe-to-frame
  motion; a point is in bounds where it lies in front (z > 1e-3), is
  valid, and projects into [1, W - 2] x [1, H - 2].  The photometric
  residual is the frame's intensity less the keyframe's, its Jacobian the
  image gradient through the projection's, weighted by Huber at
  ``huber_delta``; with depth, the geometric residual z - D(u, v), kept
  where D > 1e-3, D and its gradient are finite, the squared depth
  gradient is under 0.25 and |z - D| < 0.5, with Jacobian dz - grad D .
  d(u, v), weighted ``depth_weight`` times Huber at ``huber_depth``.
  Twists are [translation, rotation]; the step solves the normal
  equations damped by 1e-6 I and updates the motion on the left by the
  exponential of minus the solution;
- each level from ``n_levels - 1`` down to ``finest_level`` runs
  ``gn_iters`` steps; the valid fraction is the in-bounds points at the
  finest level over the valid points;
- a frame's motion starts from the velocity (the last tracked frame's
  motion) applied to the previous pose; at a valid fraction of at least
  ``min_valid_frac`` the frame is tracked and a new keyframe is made where
  the fraction is under ``kf_overlap`` or ``kf_max_gap`` frames have been
  tracked since the keyframe; under it the pose coasts on the velocity and
  a keyframe is made.

Departures from the program, none of which changes what is computed:
poses are 4x4 matrices and not [t, quaternion] vectors, the exponential
is the matrix exponential of the twist, the resize is a pair of weight
matrices and the blur a sum of shifted copies.  With ``dtype`` below
float32 the solve and the exponential run in float32, which the library
requires.

Nothing here imports the program, JAX or the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

BLUR_RADIUS = 3
BORDER = 2          # a selected pixel keeps this far from every border
DAMPING = 1e-6


@dataclass
class Keyframe:
    X: torch.Tensor          # (K, 3) points in the keyframe camera
    valid: torch.Tensor      # (K,) bool
    refs: List[torch.Tensor]  # each level's intensity at the points
    pose_cw: torch.Tensor    # (4, 4) world to keyframe camera


@dataclass
class Step:
    """One frame's outcome from the state before it."""

    frac: float              # valid fraction at the finest level
    tracked: bool
    pose_wc: torch.Tensor    # (4, 4) the pose returned
    velocity: torch.Tensor   # (4, 4) frame to previous frame motion
    new_keyframe: bool


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = w.new_zeros(())
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def _resize_weights(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """(n_out, n_in) antialiased linear weights, each row normalised."""
    s = n_in / n_out
    j = torch.arange(n_in, dtype=torch.float64, device=device) + 0.5
    c = s * (torch.arange(n_out, dtype=torch.float64, device=device)
             + 0.5)
    w = (1.0 - (j[None, :] - c[:, None]).abs() / max(s, 1.0)).clamp_min(0)
    return (w / w.sum(1, keepdim=True)).to(dtype)


class PlainDirect:
    """The direct odometry of ``slam`` (a configuration's ``slam`` table)
    for a pinhole camera of ``sensor`` (``fx``, ``fy``, ``cx``, ``cy``)."""

    def __init__(self, sensor: dict, slam: dict, device="cpu",
                 dtype=torch.float64):
        self.fx, self.fy = float(sensor["fx"]), float(sensor["fy"])
        self.cx, self.cy = float(sensor["cx"]), float(sensor["cy"])
        self.c = dict(slam)
        self.device = torch.device(device)
        self.dtype = dtype
        # the solve and the exponential need at least float32
        self.wide = torch.promote_types(dtype, torch.float32)

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).to(
            self.dtype)

    # -- images --------------------------------------------------------
    def blur(self, img: torch.Tensor) -> torch.Tensor:
        x = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=torch.float64)
        k = torch.exp(-0.5 * (x / self.c["blur_sigma"]) ** 2)
        k = (k / k.sum()).tolist()
        H, W = img.shape
        r = BLUR_RADIUS
        p = img.new_zeros((H, W + 2 * r))
        p[:, r:r + W] = img
        rows = sum(k[t] * p[:, t:t + W] for t in range(2 * r + 1))
        p = img.new_zeros((H + 2 * r, W))
        p[r:r + H] = rows
        return sum(k[t] * p[t:t + H] for t in range(2 * r + 1))

    def pyramid(self, image) -> List[torch.Tensor]:
        img = self.blur(self.tensor(image))
        H, W = img.shape
        out = [img]
        s = self.c["scale"]
        for i in range(1, self.c["n_levels"]):
            h, w = int(round(H / s ** i)), int(round(W / s ** i))
            Ay = _resize_weights(H, h, self.dtype, self.device)
            Ax = _resize_weights(W, w, self.dtype, self.device)
            out.append(Ay @ img @ Ax.T)
        return out

    @staticmethod
    def gradients(img: torch.Tensor):
        gx = torch.zeros_like(img)
        gy = torch.zeros_like(img)
        gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
        gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
        return gx, gy

    @staticmethod
    def depth_level(depth: torch.Tensor, shape) -> torch.Tensor:
        H, W = depth.shape
        h, w = shape
        iy = torch.clamp((torch.arange(h, dtype=torch.float64) + 0.5)
                         * (H / h), max=H - 1).floor().long()
        ix = torch.clamp((torch.arange(w, dtype=torch.float64) + 0.5)
                         * (W / w), max=W - 1).floor().long()
        return depth[iy.to(depth.device)][:, ix.to(depth.device)]

    def intrinsics(self, shape, base):
        sy, sx = shape[0] / base[0], shape[1] / base[1]
        return (self.fx * sx, self.fy * sy, (self.cx + 0.5) * sx - 0.5,
                (self.cy + 0.5) * sy - 0.5)

    @staticmethod
    def bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        H, W = img.shape
        # clamped as integers: a float below float32 cannot hold every
        # pixel index
        xi = torch.floor(u.clamp(-1, W)).long().clamp(0, W - 2)
        yi = torch.floor(v.clamp(-1, H)).long().clamp(0, H - 2)
        ax = (u - xi).clamp(0, 1)
        ay = (v - yi).clamp(0, 1)
        top = img[yi, xi] * (1 - ax) + img[yi, xi + 1] * ax
        bot = img[yi + 1, xi] * (1 - ax) + img[yi + 1, xi + 1] * ax
        return top * (1 - ay) + bot * ay

    # -- keyframe ------------------------------------------------------
    def keyframe(self, pyr, depth, pose_cw: torch.Tensor) -> Keyframe:
        c = self.c
        img = pyr[0]
        H, W = img.shape
        d = self.tensor(depth)
        gx, gy = self.gradients(img)
        mag = gx * gx + gy * gy
        ok = (d > c["min_depth"]) & (d < c["max_depth"]) & torch.isfinite(d)
        yy = torch.arange(H, device=self.device)[:, None]
        xx = torch.arange(W, device=self.device)[None, :]
        ok &= ((xx >= BORDER) & (xx < W - BORDER) & (yy >= BORDER)
               & (yy < H - BORDER))
        score = torch.where(ok, mag, torch.full_like(mag, -1.0)).reshape(-1)
        # descending, ties to the lowest index
        order = torch.sort(score, descending=True, stable=True).indices
        idx = order[:c["n_points"]]
        valid = score[idx] > 0
        u = (idx % W).to(self.dtype)
        v = torch.div(idx, W, rounding_mode="floor").to(self.dtype)
        z = d.reshape(-1)[idx]
        X = torch.stack([(u - self.cx) / self.fx * z,
                         (v - self.cy) / self.fy * z, z], -1)
        refs = []
        for lvl in pyr:
            fx, fy, cx, cy = self.intrinsics(lvl.shape, img.shape)
            refs.append(self.bilinear(lvl, fx * X[:, 0] / X[:, 2] + cx,
                                      fy * X[:, 1] / X[:, 2] + cy))
        return Keyframe(X, valid, refs, pose_cw.to(self.dtype))

    # -- alignment -----------------------------------------------------
    def inv(self, M: torch.Tensor) -> torch.Tensor:
        return torch.linalg.inv(M.to(self.wide)).to(self.dtype)

    def exp(self, xi: torch.Tensor) -> torch.Tensor:
        """4x4 exponential of the twist [translation, rotation]."""
        xi = xi.to(self.wide)
        M = xi.new_zeros((4, 4))
        M[:3, :3] = _hat(xi[3:])
        M[:3, 3] = xi[:3]
        return torch.linalg.matrix_exp(M).to(self.dtype)

    def _system(self, T, kf, li, img, gx, gy, depth, dgx, dgy, fx, fy, cx,
                cy):
        """(H, b, in-bounds) at motion T."""
        c = self.c
        Hh, Ww = img.shape
        p = kf.X @ T[:3, :3].T + T[:3, 3]
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        front = z > 1e-3
        zs = torch.where(front, z, torch.ones_like(z))
        u = fx * x / zs + cx
        v = fy * y / zs + cy
        inb = (front & kf.valid & (u >= 1) & (u <= Ww - 2) & (v >= 1)
               & (v <= Hh - 2))
        r = self.bilinear(img, u, v) - kf.refs[li]
        o = torch.zeros_like(x)
        Ju = fx * torch.stack([1 / zs, o, -x / zs ** 2, -x * y / zs ** 2,
                               1 + x * x / zs ** 2, -y / zs], -1)
        Jv = fy * torch.stack([o, 1 / zs, -y / zs ** 2,
                               -(1 + y * y / zs ** 2), x * y / zs ** 2,
                               x / zs], -1)
        J = (self.bilinear(gx, u, v)[:, None] * Ju
             + self.bilinear(gy, u, v)[:, None] * Jv)
        w = torch.where(inb, self.huber(r, c["huber_delta"]),
                        torch.zeros_like(r))
        H = (J * w[:, None]).T @ J
        b = (J * w[:, None]).T @ r
        if depth is not None:
            ui = torch.round(u.clamp(-1, Ww)).long().clamp(0, Ww - 1)
            vi = torch.round(v.clamp(-1, Hh)).long().clamp(0, Hh - 1)
            D, du, dv = depth[vi, ui], dgx[vi, ui], dgy[vi, ui]
            rd = z - D
            ok = (inb & (D > 1e-3) & torch.isfinite(D) & torch.isfinite(du)
                  & torch.isfinite(dv) & (du * du + dv * dv < 0.25)
                  & (rd.abs() < 0.5))
            rd, du, dv = (torch.where(ok, t, o) for t in (rd, du, dv))
            Jz = torch.stack([o, o, torch.ones_like(x), y, -x, o], -1)
            Jd = Jz - du[:, None] * Ju - dv[:, None] * Jv
            wd = torch.where(ok, c["depth_weight"]
                             * self.huber(rd, c["huber_depth"]), o)
            H = H + (Jd * wd[:, None]).T @ Jd
            b = b + (Jd * wd[:, None]).T @ rd
        return H, b, inb

    @staticmethod
    def huber(r: torch.Tensor, delta: float) -> torch.Tensor:
        a = r.abs()
        return torch.where(a <= delta, torch.ones_like(a),
                           delta / a.clamp_min(1e-12))

    def align(self, kf: Keyframe, pyr, depth, T: torch.Tensor):
        """(T_ck, valid fraction) from the initial motion ``T``."""
        c = self.c
        T = T.to(self.dtype)
        d = None if depth is None or not c["use_depth_residual"] \
            else self.tensor(depth)
        base = pyr[0].shape
        eye = torch.eye(6, dtype=self.wide, device=self.device) * DAMPING
        for li in range(c["n_levels"] - 1, c["finest_level"] - 1, -1):
            img = pyr[li]
            gx, gy = self.gradients(img)
            dl = dgx = dgy = None
            if d is not None:
                dl = self.depth_level(d, img.shape)
                dgx, dgy = self.gradients(dl)
            intr = self.intrinsics(img.shape, base)
            for _ in range(c["gn_iters"]):
                H, b, _ = self._system(T, kf, li, img, gx, gy, dl, dgx,
                                       dgy, *intr)
                x, info = torch.linalg.solve_ex(H.to(self.wide) + eye,
                                                b.to(self.wide))
                if int(info):
                    x = torch.full_like(x, math.nan)
                T = self.exp(-x) @ T
            _, _, inb = self._system(T, kf, li, img, gx, gy, dl, dgx,
                                     dgy, *intr)
        return T, int(inb.sum()) / max(int(kf.valid.sum()), 1)

    # -- one frame -----------------------------------------------------
    def step(self, kf: Keyframe, pyr, depth, pose_wc: torch.Tensor,
             velocity: torch.Tensor, gap: int) -> Step:
        """Track a frame against ``kf`` from the previous pose and
        velocity; ``gap`` is the tracked frames since the keyframe,
        this one included."""
        c = self.c
        pose_wc, velocity = pose_wc.to(self.dtype), velocity.to(self.dtype)
        T0 = velocity @ self.inv(pose_wc) @ self.inv(kf.pose_cw)
        T, frac = self.align(kf, pyr, depth, T0)
        tracked = frac >= c["min_valid_frac"]
        if tracked:
            pose_cw = T @ kf.pose_cw
            velocity = pose_cw @ pose_wc
            pose_wc = self.inv(pose_cw)
            new_kf = frac < c["kf_overlap"] or gap >= c["kf_max_gap"]
        else:
            pose_wc = self.inv(velocity @ self.inv(pose_wc))
            new_kf = True
        return Step(frac, tracked, pose_wc, velocity, new_kf)

    def run(self, frames) -> List[Step]:
        """Free-running over ``frames`` (objects with ``image`` and
        ``depth``): each frame's outcome, the first a keyframe at the
        identity."""
        eye = torch.eye(4, dtype=self.dtype, device=self.device)
        pose_wc, velocity = eye, eye
        kf: Optional[Keyframe] = None
        gap = 0
        out = []
        for fr in frames:
            pyr = self.pyramid(fr.image)
            if kf is None:
                kf = self.keyframe(pyr, fr.depth, eye)
                out.append(Step(0.0, True, eye, eye, True))
                continue
            s = self.step(kf, pyr, fr.depth, pose_wc, velocity, gap + 1)
            pose_wc, velocity = s.pose_wc, s.velocity
            gap += 1
            if s.new_keyframe:
                kf = self.keyframe(pyr, fr.depth, self.inv(pose_wc))
                gap = 0
            out.append(s)
        return out
