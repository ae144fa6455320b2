"""KITTI odometry dataset player.

Counterpart of ``gslam_tpu/datasets/kitti.py``.  The public KITTI
odometry layout:

    <seq>/image_0/NNNNNN.png   left gray
    <seq>/image_1/NNNNNN.png   right gray
    <seq>/times.txt            per-frame time (s)
    <seq>/calib.txt            "P0: <12 floats>" .. "P3:" projections
    ground truth at <seq>/poses.txt or <root>/poses/<seq_id>.txt
    (3x4 row-major cam0 -> world)

A ``.kitti`` path names the sequence directory without the extension.
Gray images decode through the native library's float32 gray (the
reference's native-first ``imread_gray_f32``); the image size comes
from the decoder.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from gslam_tpu_torch.app.registry import DATASETS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.so3 import matrix_to_quat
from gslam_tpu_torch.datasets.base import Dataset, FrameData
from gslam_tpu_torch.datasets.native_loader import read_gray_f32


def _read_calib(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals = [float(x) for x in v.split()]
            if len(vals) == 12:
                out[k.strip()] = np.asarray(vals).reshape(3, 4)
    return out


def read_kitti_poses(path: str) -> np.ndarray:
    """poses.txt -> (N, 7) cam -> world [t, q wxyz] (float32 rotations
    to quaternions, as the reference's)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    q = matrix_to_quat(torch.as_tensor(rows[:, :, :3], dtype=torch.float32))
    return np.concatenate([rows[:, :, 3], q.numpy()], -1).astype(np.float32)


class KITTIDataset(Dataset):
    def _open(self, path: str) -> bool:
        root = path[:-len(".kitti")] if path.endswith(".kitti") else path
        cpath = os.path.join(root, "calib.txt")
        if not os.path.isfile(cpath):
            return False
        self.root = root
        calib = _read_calib(cpath)
        P0 = calib.get("P0")
        P1 = calib.get("P1")
        if P0 is None:
            return False
        self.left = sorted(glob.glob(os.path.join(root, "image_0", "*.png")))
        self.right = sorted(glob.glob(os.path.join(root, "image_1", "*.png")))
        if not self.left:
            return False
        tpath = os.path.join(root, "times.txt")
        self.times = (np.loadtxt(tpath).reshape(-1)
                      if os.path.isfile(tpath)
                      else np.arange(len(self.left)) * 0.1)
        H, W = read_gray_f32(self.left[0]).shape
        fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
        self.camera = Camera.pinhole(W, H, fx, fy, cx, cy)
        self.camera_right = self.camera
        # stereo baseline from P1: t_x = -fx * b
        self.baseline = float(-P1[0, 3] / P1[0, 0]) if P1 is not None else 0.0
        self.gt: Optional[np.ndarray] = None
        for cand in (os.path.join(root, "poses.txt"),
                     os.path.join(os.path.dirname(root.rstrip("/")), "poses",
                                  os.path.basename(root.rstrip("/"))
                                  + ".txt")):
            if os.path.isfile(cand):
                self.gt = read_kitti_poses(cand)
                break
        return True

    def _length(self) -> int:
        return len(self.left)

    def _grab(self, idx: int) -> Optional[FrameData]:
        if idx >= len(self.left):
            return None
        gray = read_gray_f32(self.left[idx])
        right = None
        if idx < len(self.right):
            right = read_gray_f32(self.right[idx])
        gt = self.gt[idx] if self.gt is not None and idx < len(self.gt) \
            else None
        return FrameData(id=idx, timestamp=float(self.times[idx]),
                         image=gray, camera=self.camera,
                         image_right=right, camera_right=self.camera_right,
                         stereo_baseline=self.baseline, gt_pose=gt)


@DATASETS.register("kitti")
def _make_kitti() -> KITTIDataset:
    return KITTIDataset()
