"""TUM RGB-D and TUM monoVO dataset players.

Counterpart of ``gslam_tpu/datasets/tum_rgbd.py``.  The public TUM RGB-D
layout:

    <seq>/rgb.txt          "# comments", then "timestamp rgb/<t>.png"
    <seq>/depth.txt        "timestamp depth/<t>.png" (16-bit, 5000 / m)
    <seq>/groundtruth.txt  "t tx ty tz qx qy qz qw" (cam -> world)

A ``.tumrgbd`` path names the sequence directory without the extension
(``/data/fr1_desk.tumrgbd`` opens ``/data/fr1_desk/``); a bare directory
holding rgb.txt opens too.  Depth and ground truth attach to each colour
frame by the nearest timestamp within 20 ms.  The camera is the
benchmark's Freiburg-1 calibration (OpenCV radial-tangential) unless a
``calib.txt`` holds "fx fy cx cy [k1 k2 p1 p2 [k3]]".

Images decode through the native library: colour as its raw RGB bytes,
then :func:`~gslam_tpu_torch.core.image.to_gray_f32` (float64 luma, one
cast); depth as its raw big-endian 16-bit samples / 5000.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from gslam_tpu_torch.app.registry import DATASETS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.image import to_gray_f32
from gslam_tpu_torch.datasets.base import Dataset, FrameData
from gslam_tpu_torch.datasets.native_loader import read_rgb_u8

DEPTH_SCALE = 5000.0  # 16-bit depth units per metre


def _read_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def read_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """groundtruth.txt -> (timestamps (N,), poses (N, 7) [t, q wxyz])."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            ts.append(v[0])
            # file order tx ty tz qx qy qz qw -> [t, qw qx qy qz]
            poses.append([v[1], v[2], v[3], v[7], v[4], v[5], v[6]])
    return np.asarray(ts), np.asarray(poses, np.float32)


def _nearest(ts_list: np.ndarray, t: float, max_dt: float
             ) -> Optional[int]:
    if len(ts_list) == 0:
        return None
    i = int(np.argmin(np.abs(ts_list - t)))
    return i if abs(ts_list[i] - t) <= max_dt else None


def _read_numbers(path: str) -> List[float]:
    with open(path) as f:
        return [float(x) for x in f.read().split()]


class TUMRGBDDataset(Dataset):
    def _open(self, path: str) -> bool:
        root = path[:-len(".tumrgbd")] if path.endswith(".tumrgbd") else path
        if not os.path.isfile(os.path.join(root, "rgb.txt")):
            return False
        self.root = root
        self.rgb = _read_list(os.path.join(root, "rgb.txt"))
        dpath = os.path.join(root, "depth.txt")
        self.depth = _read_list(dpath) if os.path.isfile(dpath) else []
        self.depth_ts = np.asarray([t for t, _ in self.depth])
        gpath = os.path.join(root, "groundtruth.txt")
        if os.path.isfile(gpath):
            self.gt_ts, self.gt_poses = read_trajectory(gpath)
        else:
            self.gt_ts = np.zeros(0)
            self.gt_poses = np.zeros((0, 7), np.float32)
        cpath = os.path.join(root, "calib.txt")
        if os.path.isfile(cpath):
            v = _read_numbers(cpath)
            if len(v) >= 8:     # k3 defaults to 0
                self.camera = Camera.opencv(640, 480, *v[:9])
            else:
                self.camera = Camera.pinhole(640, 480, *v[:4])
        else:
            # the benchmark's published Freiburg-1 calibration
            self.camera = Camera.opencv(
                640, 480, 517.3, 516.5, 318.6, 255.3,
                0.2624, -0.9531, -0.0054, 0.0026, 1.1633)
        return True

    def _length(self) -> int:
        return len(self.rgb)

    def _grab(self, idx: int) -> Optional[FrameData]:
        if idx >= len(self.rgb):
            return None
        t, rel = self.rgb[idx]
        color = read_rgb_u8(os.path.join(self.root, rel))
        gray = to_gray_f32(color)
        depth = None
        di = _nearest(self.depth_ts, t, 0.02)
        if di is not None:
            d16 = read_rgb_u8(os.path.join(self.root, self.depth[di][1]))
            depth = d16.astype(np.float32) / DEPTH_SCALE
        gt = None
        gi = _nearest(self.gt_ts, t, 0.02) if len(self.gt_ts) else None
        if gi is not None:
            gt = self.gt_poses[gi]
        return FrameData(id=idx, timestamp=t, image=gray, camera=self.camera,
                         color=color if color.ndim == 3 else None,
                         depth=depth, gt_pose=gt)


@DATASETS.register("tumrgbd")
def _make_tumrgbd() -> TUMRGBDDataset:
    return TUMRGBDDataset()


class TUMMonoDataset(TUMRGBDDataset):
    """TUM monoVO: images.txt ("t filename") and an ATAN camera from
    camera.txt ("fx fy cx cy w [W H]", normalized, PTAM's convention)."""

    def _open(self, path: str) -> bool:
        root = path[:-len(".tummono")] if path.endswith(".tummono") else path
        ipath = os.path.join(root, "images.txt")
        if not os.path.isfile(ipath):
            return False
        self.root = root
        self.rgb = _read_list(ipath)
        self.depth = []
        self.depth_ts = np.zeros(0)
        self.gt_ts = np.zeros(0)
        self.gt_poses = np.zeros((0, 7), np.float32)
        cpath = os.path.join(root, "camera.txt")
        W, H = 640, 480
        if os.path.isfile(cpath):
            v = _read_numbers(cpath)[:7]
            if len(v) >= 7:
                W, H = int(v[5]), int(v[6])
            # normalized fx fy cx cy (PTAM): scaled by the image size
            self.camera = Camera.atan(W, H, v[0] * W, v[1] * H,
                                      v[2] * W - 0.5, v[3] * H - 0.5, v[4])
        else:
            self.camera = Camera.from_fov(W, H, 70.0)
        return True


@DATASETS.register("tummono")
def _make_tummono() -> TUMMonoDataset:
    return TUMMonoDataset()
