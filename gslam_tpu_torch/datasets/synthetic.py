"""Synthetic dataset: rendered dot-world sequences with exact ground truth.

The port's own numpy copy of ``gslam_tpu/datasets/synthetic.py``: the
same world, trajectories ("line", "orbit", "ring", "ring_out"), value-
noise texture with exact per-pixel depth, exposure jitter, stereo and
IMU windows and radial distortion, giving bit-equal images, depth and
poses from the same configuration.  The only computation the reference
ran in JAX, the per-pixel ray table of the textured backdrop, goes
through the port's ``Camera.unproject`` on the CPU in float32 (for the
distorted OpenCV camera its fixed 8-step undistortion).

A ``.synth`` dataset path is a JSON file of ``cfg`` overrides, e.g.
``{"n_frames": 60, "width": 320, "height": 240, "motion": "orbit"}``;
the extension "synth" is registered.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from gslam_tpu_torch.app.registry import DATASETS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.datasets.base import Dataset, FrameData


def _matrix_to_quat_np(R: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> (4,) wxyz quaternion (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def _pose_cam_to_world(motion: str, i: int, n: int, radius: float):
    """Returns (R_wc (3,3), t_wc (3,)): camera->world."""
    if motion == "line":
        t = np.array([0.08 * i, 0.0, 0.0])
        yaw = 0.0
    elif motion == "ring":
        # full circle looking at the world centre (revisits the start)
        a = 2 * np.pi * i / max(n, 1)
        t = np.array([radius * np.sin(a), 0.0, -radius * np.cos(a)])
        yaw = -a
    elif motion == "ring_out":
        # full circle looking outward at the surrounding cylinder: views
        # overlap only temporally nearby frames and the revisit
        a = 2 * np.pi * i / max(n, 1)
        t = np.array([radius * np.sin(a), 0.0, -radius * np.cos(a)])
        yaw = np.pi - a
    else:  # orbit: look at the world centre from a half circle
        a = 2 * np.pi * i / max(n, 1) * 0.5
        t = np.array([radius * np.sin(a), 0.0, -radius * np.cos(a)])
        yaw = -a
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
    return R_wc, t


def _value_noise(seed: int, n_grid: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n_grid, n_grid))


def _sample_noise(grid: np.ndarray, u: np.ndarray, v: np.ndarray,
                  octaves: int = 3) -> np.ndarray:
    """Bilinear value noise at (u, v) in texture units, 3 octaves."""
    n = grid.shape[0]
    out = np.zeros_like(u, np.float32)
    amp = 1.0
    tot = 0.0
    for o in range(octaves):
        s = 2.0 ** o
        x = (u * s) % n
        y = (v * s) % n
        x0 = np.floor(x).astype(np.int64) % n
        y0 = np.floor(y).astype(np.int64) % n
        x1 = (x0 + 1) % n
        y1 = (y0 + 1) % n
        fx = (x - np.floor(x)).astype(np.float32)
        fy = (y - np.floor(y)).astype(np.float32)
        v00 = grid[y0, x0]
        v01 = grid[y0, x1]
        v10 = grid[y1, x0]
        v11 = grid[y1, x1]
        val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
               + v10 * (1 - fx) * fy + v11 * fx * fy)
        out += amp * val.astype(np.float32)
        tot += amp
        amp *= 0.5
    return out / tot


class SyntheticDataset(Dataset):
    """Configured by keyword overrides of ``cfg`` (or a JSON file path in
    ``open``), as the reference's dataset is: ``texture`` ray-casts a
    textured backdrop (plane for "line", cylinder otherwise) with exact
    depth; ``exposure`` jitters the gain; ``stereo`` renders a right
    view; ``imu`` attaches ground-truth IMU windows; ``distortion``
    [k1, k2] renders through a radially distorted OpenCV camera."""

    def __init__(self, **overrides):
        super().__init__()
        self.cfg = dict(n_frames=60, n_points=300, width=320, height=240,
                        motion="orbit", seed=3, fov_deg=70.0, radius=8.0,
                        depth=True, dot_half=1, world_extent=6.0,
                        noise=0.0, stereo=False, baseline=0.3,
                        imu=False, imu_rate=10, imu_noise=0.0,
                        texture=False, exposure=0.0, distortion=None,
                        laps=1)
        self.cfg.update(overrides)

    def _open(self, path: str) -> bool:
        if path and not path.startswith("synth://"):
            with open(path) as f:
                self.cfg.update(json.load(f))
        c = self.cfg
        rng = np.random.default_rng(c["seed"])
        e = c["world_extent"]
        n = c["n_points"]
        if c["motion"] == "line":
            x = rng.uniform(-e * 0.5, e * 2.0, n)
            y = rng.uniform(-e * 0.6, e * 0.6, n)
            z = e + 0.25 * e * np.sin(1.5 * x / e) * np.cos(2.0 * y / e)
            self.X = np.stack([x, y, z], -1)
        else:
            x = rng.uniform(-e, e, n)
            y = rng.uniform(-e * 0.6, e * 0.6, n)
            z = 0.25 * e * np.sin(2.0 * x / e) * np.cos(1.5 * y / e)
            self.X = np.stack([x, y, z], -1)
        self.I = rng.uniform(0.55, 1.0, c["n_points"])
        self.X_bg = np.zeros((0, 3))
        self.I_bg = np.zeros((0,))
        if c["texture"]:
            m = int(c.get("n_texture", 3000))
            e = c["world_extent"]
            if c["motion"] == "line":
                z0 = 1.35 * e
                bx = rng.uniform(-e, e * 3.0, m)
                by = rng.uniform(-e * 1.2, e * 1.2, m)
                self.X_bg = np.stack([bx, by, np.full(m, z0)], -1)
            else:
                R_cyl = 1.8 * c["radius"]
                th = rng.uniform(0, 2 * np.pi, m)
                by = rng.uniform(-e * 1.2, e * 1.2, m)
                self.X_bg = np.stack([R_cyl * np.sin(th), by,
                                      R_cyl * np.cos(th)], -1)
            self.I_bg = rng.uniform(0.45, 1.0, m)
        W, H = c["width"], c["height"]
        base = Camera.from_fov(W, H, c["fov_deg"])
        if c["distortion"]:
            k1, k2 = float(c["distortion"][0]), float(c["distortion"][1])
            self.camera = Camera.opencv(W, H, float(base.fx), float(base.fy),
                                        float(base.cx), float(base.cy),
                                        k1, k2)
            self._dist = (k1, k2)
        else:
            self.camera = base
            self._dist = None
        if c["texture"]:
            # per-pixel z = 1 ray table through the camera's unproject in
            # float32 on the CPU (for the distorted camera the iterative
            # undistortion, once at open time)
            uu, vv = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
            uv = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)
            rays = self.camera.unproject(torch.from_numpy(uv)).numpy()
            self._ray_lut = (rays / rays[:, 2:3]).reshape(H, W, 3) \
                .astype(np.float32)
            self._tex = _value_noise(c["seed"] + 7)
        self.rng = rng
        return True

    def _length(self) -> int:
        return self.cfg["n_frames"]

    def _render(self, R_wc, t_wc, want_depth: bool):
        """Splat the world dots as seen from camera pose (R_wc, t_wc)."""
        c = self.cfg
        H, W = c["height"], c["width"]
        R_cw = R_wc.T
        t_cw = -R_cw @ t_wc
        X_all, I_all = self.X, self.I
        if len(self.X_bg):
            X_all = np.concatenate([self.X, self.X_bg])
            I_all = np.concatenate([self.I, self.I_bg])
        pc = X_all @ R_cw.T + t_cw
        z = pc[:, 2]
        front = z > 0.5
        xn = pc[:, 0] / np.maximum(z, 1e-6)
        yn = pc[:, 1] / np.maximum(z, 1e-6)
        if self._dist is not None:
            k1, k2 = self._dist
            r2 = xn * xn + yn * yn
            f = 1.0 + k1 * r2 + k2 * r2 * r2
            xn, yn = xn * f, yn * f
        u = self.camera.fx * xn + self.camera.cx
        v = self.camera.fy * yn + self.camera.cy

        img = np.zeros((H, W), np.float32)
        depth_img = np.zeros((H, W), np.float32) if want_depth else None
        if c["texture"]:
            d_c = self._ray_lut                       # (H, W, 3), z=1
            d_w = d_c @ R_wc.T
            e = c["world_extent"]
            if c["motion"] == "line":
                z0 = 1.35 * e
                s = (z0 - t_wc[2]) / np.where(
                    np.abs(d_w[..., 2]) < 1e-6, 1e-6, d_w[..., 2])
                Xw = t_wc[None, None] + s[..., None] * d_w
                tu = Xw[..., 0] * 2.0
                tv = Xw[..., 1] * 2.0
            else:
                R_cyl = 1.8 * c["radius"]
                ox, oz = t_wc[0], t_wc[2]
                dx, dz = d_w[..., 0], d_w[..., 2]
                a = dx * dx + dz * dz
                b = 2.0 * (ox * dx + oz * dz)
                cc = ox * ox + oz * oz - R_cyl * R_cyl
                disc = np.maximum(b * b - 4 * a * cc, 0.0)
                s = (-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-9)
                Xw = t_wc[None, None] + s[..., None] * d_w
                theta = np.arctan2(Xw[..., 0], Xw[..., 2])
                tu = theta * R_cyl * 2.0
                tv = Xw[..., 1] * 2.0
            hit = s > 0.5
            tex = _sample_noise(self._tex, tu, tv)
            # quantized low-contrast base layer (steps below the FAST
            # threshold); the dots carry the trackable texture
            tex = np.floor(tex * 5.0) / 4.0
            img = np.where(hit, 0.08 + 0.18 * tex, 0.08) \
                .astype(np.float32)
            if depth_img is not None:
                depth_img = np.where(hit, s, 0.0).astype(np.float32)
        else:
            img += (0.08 + 0.04 * np.linspace(0, 1, W))[None, :]
        r = c["dot_half"]
        ui = np.round(u).astype(np.int64)
        vi = np.round(v).astype(np.int64)
        ok = front & (ui >= r + 1) & (ui < W - r - 1) & (vi >= r + 1) \
            & (vi < H - r - 1)
        for j in np.nonzero(ok)[0]:
            img[vi[j] - r:vi[j] + r + 1, ui[j] - r:ui[j] + r + 1] = I_all[j]
            if depth_img is not None:
                depth_img[vi[j] - r:vi[j] + r + 1,
                          ui[j] - r:ui[j] + r + 1] = z[j]
        if c["noise"] > 0:
            img = img + self.rng.normal(0, c["noise"], img.shape) \
                .astype(np.float32)
        return img.clip(0.0, 1.0).astype(np.float32), depth_img

    def _imu_window(self, idx: int) -> Optional[np.ndarray]:
        """Ground-truth IMU samples covering (t[idx-1], t[idx]]: constant
        body rate from the relative rotation, world acceleration from the
        second difference of camera centres minus gravity (body frame =
        camera frame)."""
        c = self.cfg
        if idx == 0:
            return np.zeros((0, 7), np.float32)
        n, m = c["n_frames"] // int(c.get("laps", 1)), int(c["imu_rate"])
        dt_f = 1.0 / 30.0
        R0, t0 = _pose_cam_to_world(c["motion"], idx - 1, n, c["radius"])
        R1, t1 = _pose_cam_to_world(c["motion"], idx, n, c["radius"])
        dR = R0.T @ R1
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
        if angle < 1e-9:
            axis = np.zeros(3)
        else:
            axis = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                             dR[1, 0] - dR[0, 1]]) / (2 * np.sin(angle))
        w_body = axis * angle / dt_f
        Rp, tp = _pose_cam_to_world(c["motion"], idx - 2, n, c["radius"])
        a_w = (t1 - 2 * t0 + tp) / dt_f ** 2
        g_w = np.array([0.0, 0.0, -9.81])
        a_body = R0.T @ (a_w - g_w)
        ts = (idx - 1) / 30.0 + dt_f * (np.arange(0, m + 1) / m)
        rows = np.concatenate([
            ts[:, None],
            np.tile(a_body, (m + 1, 1)), np.tile(w_body, (m + 1, 1))], -1)
        if c["imu_noise"] > 0:
            rows[:, 1:] += self.rng.normal(0, c["imu_noise"],
                                           rows[:, 1:].shape)
        return rows.astype(np.float32)

    def _grab(self, idx: int) -> Optional[FrameData]:
        c = self.cfg
        if idx >= c["n_frames"]:
            return None
        # laps > 1 repeats the closed trajectory: lap 2+ revisits lap 1
        n_lap = c["n_frames"] // int(c.get("laps", 1))
        R_wc, t_wc = _pose_cam_to_world(c["motion"], idx, n_lap,
                                        c["radius"])
        img, depth_img = self._render(R_wc, t_wc, c["depth"])
        gain = 1.0
        if c["exposure"] > 0:
            gain = 1.0 + c["exposure"] * np.sin(
                2 * np.pi * 3.0 * idx / max(c["n_frames"], 1))
            img = (img * gain).clip(0.0, 1.0).astype(np.float32)
        img_right = None
        baseline = 0.0
        if c["stereo"]:
            baseline = c["baseline"]
            t_wc_right = t_wc + R_wc @ np.array([baseline, 0.0, 0.0])
            img_right, _ = self._render(R_wc, t_wc_right, False)
            if gain != 1.0:
                img_right = (img_right * gain).clip(0.0, 1.0) \
                    .astype(np.float32)
        q_wc = _matrix_to_quat_np(R_wc)
        gt = np.concatenate([t_wc, q_wc]).astype(np.float32)
        return FrameData(id=idx, timestamp=idx / 30.0, image=img,
                         camera=self.camera, depth=depth_img, gt_pose=gt,
                         image_right=img_right,
                         camera_right=self.camera if img_right is not None
                         else None,
                         stereo_baseline=baseline,
                         imu=self._imu_window(idx) if c["imu"] else None)


@DATASETS.register("synth")
def _make_synth(**kw) -> SyntheticDataset:
    return SyntheticDataset(**kw)
