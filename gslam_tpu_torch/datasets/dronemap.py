"""Drone-mapping dataset (the DroneMap / RTMapper layout).

Counterpart of ``gslam_tpu/datasets/dronemap.py``.  ``<seq>.dronemap``
names a directory holding

    images/    frame images (sorted by name)
    gps.txt    "t lat lon alt [yaw_deg]" per frame (1:1 with images)
    calib.txt  "fx fy cx cy [k1 k2 p1 p2 k3]"

GPS rows attach to their frames and become a local-ENU ground-truth
trajectory (the first fix is the origin; float64 on the host).  Images
decode through the native library.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from gslam_tpu_torch.app.registry import DATASETS
from gslam_tpu_torch.core.gps import lla_to_enu_np
from gslam_tpu_torch.core.image import to_gray_f32
from gslam_tpu_torch.datasets.base import Dataset, FrameData
from gslam_tpu_torch.datasets.native_loader import read_rgb_u8
from gslam_tpu_torch.datasets.video import _camera_for


class DroneMapDataset(Dataset):
    def _open(self, path: str) -> bool:
        root = path[:-len(".dronemap")] if path.endswith(".dronemap") \
            else path
        img_dir = os.path.join(root, "images")
        if not os.path.isdir(img_dir):
            return False
        pats = ("*.png", "*.jpg", "*.jpeg")
        self.files = sorted(f for p in pats
                            for f in glob.glob(os.path.join(img_dir, p)))
        if not self.files:
            return False
        self.gps = np.zeros((0, 4))
        gpath = os.path.join(root, "gps.txt")
        if os.path.isfile(gpath):
            rows = []
            with open(gpath) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    rows.append([float(x) for x in line.split()][:4])
            self.gps = np.asarray(rows)
        H, W = read_rgb_u8(self.files[0]).shape[:2]
        self.camera = _camera_for(root, W, H)
        self.enu: Optional[np.ndarray] = None
        if len(self.gps):
            self.enu = np.asarray(lla_to_enu_np(self.gps[:, 1:4],
                                                self.gps[0, 1:4]), np.float32)
        return True

    def _length(self) -> int:
        return len(self.files)

    def _grab(self, idx: int) -> Optional[FrameData]:
        if idx >= len(self.files):
            return None
        arr = read_rgb_u8(self.files[idx])
        t = self.gps[idx, 0] if idx < len(self.gps) else idx / 10.0
        gt = None
        if self.enu is not None and idx < len(self.enu):
            # position-only ground truth (identity orientation)
            gt = np.concatenate([self.enu[idx],
                                 [1.0, 0.0, 0.0, 0.0]]).astype(np.float32)
        return FrameData(
            id=idx, timestamp=float(t), image=to_gray_f32(arr),
            camera=self.camera, color=arr if arr.ndim == 3 else None,
            gps=self.gps[idx] if idx < len(self.gps) else None, gt_pose=gt)


@DATASETS.register("dronemap")
def _make_dronemap() -> DroneMapDataset:
    return DroneMapDataset()


# RTMapper sequences (".rtm") are DroneMap-layout directories
DATASETS.register("rtm")(DroneMapDataset)
