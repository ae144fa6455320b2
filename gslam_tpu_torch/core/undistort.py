"""Undistortion and stereo rectification by a precomputed remap.

Counterpart of ``gslam_tpu/core/undistort.py``.  A remap table is an
(H, W, 2) array of source pixel coordinates built once from the camera
models' unproject / project; applying it is one bilinear gather in plain
PyTorch on the image's device (:func:`_remap`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gslam_tpu_torch.core.camera import Camera


def _pixel_grid(H: int, W: int) -> torch.Tensor:
    """(H * W, 2) float32 [x, y] of every pixel, row-major."""
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([xx, yy], -1).reshape(-1, 2)


class Undistorter:
    def __init__(self, cam_in: Camera, cam_out: Optional[Camera] = None):
        """The remap table cam_in -> cam_out (by default the pinhole with
        cam_in's fx, fy, cx, cy and no distortion), built on the CPU."""
        if cam_out is None:
            cam_out = Camera.pinhole(cam_in.width, cam_in.height,
                                     cam_in.fx, cam_in.fy, cam_in.cx,
                                     cam_in.cy)
        self.cam_in = cam_in
        self.cam_out = cam_out
        H, W = cam_out.height, cam_out.width
        rays = cam_out.unproject(_pixel_grid(H, W))
        uv_src, valid = cam_in.project(rays)
        self.map_xy = uv_src.reshape(H, W, 2).numpy()
        self.valid = valid.reshape(H, W).numpy()
        self._on = {}

    def undistort(self, img: torch.Tensor) -> torch.Tensor:
        """Remap one (H, W) image on its device (bilinear; pixels that
        map outside the source image are 0)."""
        img = torch.as_tensor(img)
        dev = img.device
        if dev not in self._on:
            self._on[dev] = (torch.as_tensor(self.map_xy, device=dev),
                             torch.as_tensor(self.valid, device=dev))
        return _remap(img, *self._on[dev])


def _remap(img: torch.Tensor, map_xy: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """Bilinear gather of ``img`` (H, W) at ``map_xy`` (..., 2), 0 where
    not ``valid``; coordinates clipped to [0, W - 1.001] x [0, H - 1.001]
    so that the four taps stay inside."""
    H, W = img.shape
    x = map_xy[..., 0].clamp(0.0, W - 1.001)
    y = map_xy[..., 1].clamp(0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    out = ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
           + (v10 * (1 - fx) + v11 * fx) * fy)
    return torch.where(valid, out, torch.zeros_like(out))


class StereoRectifier:
    """Two remap tables onto a common pinhole pair whose relative pose is
    a pure x translation (Bouguet-style), resampling through the original
    (distorted) camera models, so that rectification and undistortion are
    one gather.

    With x_c1 = R10 x_c0 + t10, the common rotation R_rect has its x axis
    toward cam1's centre c = -R10^T t10 and its z axis closest to the
    mean optical axis; cam0 turns by R_rect, cam1 by R_rect R10^T.  The
    geometry is float64 on the host; the rays are cast to float32 just
    before the camera projects them."""

    def __init__(self, cam0: Camera, cam1: Camera, T_c1c0: np.ndarray,
                 cam_out: Optional[Camera] = None):
        T = np.asarray(T_c1c0, np.float64)
        R10, t10 = T[:3, :3], T[:3, 3]
        c = -R10.T @ t10                       # cam1 centre in cam0
        self.baseline = float(np.linalg.norm(c))
        e1 = c / max(np.linalg.norm(c), 1e-12)
        z_avg = np.array([0.0, 0.0, 1.0]) + R10.T @ np.array([0, 0, 1.0])
        z_avg /= max(np.linalg.norm(z_avg), 1e-12)
        e2 = np.cross(z_avg, e1)
        e2 /= max(np.linalg.norm(e2), 1e-12)
        e3 = np.cross(e1, e2)
        R_rect = np.stack([e1, e2, e3])        # new axes in old cam0
        self.R_rect = R_rect
        A = (R_rect, R_rect @ R10.T)           # per-camera rotations

        if cam_out is None:
            cam_out = Camera.pinhole(cam0.width, cam0.height,
                                     cam0.fx, cam0.fy, cam0.cx, cam0.cy)
        self.camera = cam_out
        H, W = cam_out.height, cam_out.width
        rays = cam_out.unproject(_pixel_grid(H, W)).numpy().astype(
            np.float64)
        self.maps = []
        for cam, Ai in zip((cam0, cam1), A):
            rays_old = rays @ Ai               # A^T @ ray, batched
            uv_src, valid = cam.project(torch.as_tensor(
                rays_old.astype(np.float32)))
            self.maps.append((uv_src.reshape(H, W, 2).numpy(),
                              valid.reshape(H, W).numpy()))
        self._on = {}

    def rectify_one(self, img: torch.Tensor, which: int) -> torch.Tensor:
        img = torch.as_tensor(img)
        key = (img.device, which)
        if key not in self._on:
            m, v = self.maps[which]
            self._on[key] = (torch.as_tensor(m, device=img.device),
                             torch.as_tensor(v, device=img.device))
        return _remap(img, *self._on[key])

    def rectify(self, img0: torch.Tensor, img1: torch.Tensor):
        """Remap a raw pair onto the rectified common pinhole pair."""
        return self.rectify_one(img0, 0), self.rectify_one(img1, 1)
