"""EuRoC MAV dataset player.

Counterpart of ``gslam_tpu/datasets/euroc.py``.  The public EuRoC ASL
layout under ``<seq>/mav0/``:

    cam0/data.csv            "#timestamp [ns],filename"
    cam0/data/<ts>.png       gray images
    cam0/sensor.yaml         intrinsics (pinhole + radtan), T_BS
    cam1/...                 the right camera
    imu0/data.csv            "ts,wx,wy,wz,ax,ay,az"
    state_groundtruth_estimate0/data.csv  "ts,px,py,pz,qw,qx,qy,qz,..."

A ``.euroc`` path names the directory holding mav0/ (or mav0/ itself)
without the extension.  sensor.yaml is read with a minimal line parser:
``intrinsics: [fu, fv, cu, cv]``, ``distortion_coefficients: [...]``,
``resolution: [W, H]`` and the 4x4 ``T_BS`` ``data: [...]`` block.  A
rotated stereo pair is rectified onto a common pinhole rig
(:class:`~gslam_tpu_torch.core.undistort.StereoRectifier`); IMU samples
are rotated from the body into the (rectified) cam0 frame.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Optional, Tuple

import numpy as np

from gslam_tpu_torch.app.registry import DATASETS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.image import to_gray_f32
from gslam_tpu_torch.core.undistort import StereoRectifier
from gslam_tpu_torch.datasets.base import Dataset, FrameData
from gslam_tpu_torch.datasets.native_loader import read_rgb_u8


def _yaml_list(text: str, key: str) -> Optional[List[float]]:
    m = re.search(rf"{key}:\s*\[([^\]]*)\]", text)
    if not m:
        return None
    return [float(x) for x in m.group(1).split(",")]


def _yaml_tbs(text: str) -> Optional[np.ndarray]:
    """The 4x4 row-major ``T_BS`` (sensor -> body) of a sensor.yaml's
    ``data: [...]`` block."""
    m = re.search(r"data:\s*\[([^\]]*)\]", text, re.S)
    if not m:
        return None
    vals = [float(x) for x in m.group(1).replace("\n", " ").split(",")]
    if len(vals) != 16:
        return None
    return np.asarray(vals, np.float64).reshape(4, 4)


def _read_text(path: str) -> str:
    with open(path) as f:
        return f.read()


def _load_cam(cam_dir: str) -> Tuple[Optional[Camera], List[Tuple[int, str]]]:
    data_csv = os.path.join(cam_dir, "data.csv")
    if not os.path.isfile(data_csv):
        return None, []
    entries = []
    with open(data_csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, name = line.split(",")[:2]
            entries.append((int(ts), name.strip()))
    cam = None
    ypath = os.path.join(cam_dir, "sensor.yaml")
    if os.path.isfile(ypath):
        text = _read_text(ypath)
        intr = _yaml_list(text, "intrinsics")
        res = _yaml_list(text, "resolution") or [752, 480]
        dist = _yaml_list(text, "distortion_coefficients") or [0, 0, 0, 0]
        if intr:
            k = list(dist) + [0.0] * (5 - len(dist))
            cam = Camera.opencv(int(res[0]), int(res[1]), intr[0], intr[1],
                                intr[2], intr[3], *k[:5])
    return cam, entries


def _read_csv_rows(path: str) -> List[List[float]]:
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            rows.append([float(x) for x in line.split(",")])
    return rows


class EuRoCDataset(Dataset):
    def _open(self, path: str) -> bool:
        root = path[:-len(".euroc")] if path.endswith(".euroc") else path
        if os.path.isdir(os.path.join(root, "mav0")):
            root = os.path.join(root, "mav0")
        cam0 = os.path.join(root, "cam0")
        self.rectifier = None
        self.cam, self.entries = _load_cam(cam0)
        if not self.entries:
            return False
        if self.cam is None:
            self.cam = Camera.from_fov(752, 480, 80.0)
        self.camera = self.cam
        self.root = root
        # camera-IMU extrinsics: body-frame IMU samples rotate into the
        # cam0 frame (the SLAM models take body == camera); the lever-arm
        # term is second order and left to the VI noise model
        self.R_cb = np.eye(3)
        T_BS0 = None
        ypath0 = os.path.join(cam0, "sensor.yaml")
        if os.path.isfile(ypath0):
            T_BS0 = _yaml_tbs(_read_text(ypath0))
            if T_BS0 is not None:
                self.R_cb = T_BS0[:3, :3].T   # R_SB: body -> camera
        self.cam1, self.entries1 = _load_cam(os.path.join(root, "cam1"))
        self.t1 = np.asarray([t for t, _ in self.entries1], np.int64)
        # stereo extrinsics from both T_BS blocks:
        # T_c1<-c0 = T_BS(cam1)^-1 @ T_BS(cam0), the baseline its norm
        self.baseline = 0.11       # the nominal EuRoC baseline otherwise
        self.T_c1c0 = None
        ypath1 = os.path.join(root, "cam1", "sensor.yaml")
        if T_BS0 is not None and os.path.isfile(ypath1):
            T_BS1 = _yaml_tbs(_read_text(ypath1))
            if T_BS1 is not None:
                T10 = np.linalg.inv(T_BS1) @ T_BS0
                self.T_c1c0 = T10
                self.baseline = float(np.linalg.norm(T10[:3, 3]))
                # the stereo consumers take rectified pairs: a relative
                # rotation above 0.1 deg is rectified once here and the
                # remap applied per frame
                ang = np.degrees(np.arccos(np.clip(
                    (np.trace(T10[:3, :3]) - 1) / 2, -1.0, 1.0)))
                if ang > 0.1:
                    self.rectifier = StereoRectifier(self.cam, self.cam1,
                                                     T10)
                    self.cam = self.rectifier.camera
                    self.cam1 = self.rectifier.camera
                    self.baseline = self.rectifier.baseline
                    # the IMU turns with cam0's rectified frame
                    self.R_cb = self.rectifier.R_rect @ self.R_cb
                    logging.getLogger("gslam_tpu_torch.euroc").info(
                        "cam0->cam1 rotation %.2f deg: stereo pairs will be "
                        "rectified onto a common pinhole rig (baseline %.4f "
                        "m)", ang, self.baseline)

        self.imu = np.zeros((0, 7))
        ipath = os.path.join(root, "imu0", "data.csv")
        if os.path.isfile(ipath):
            # csv ts, wx, wy, wz, ax, ay, az -> [t_s, ax, ay, az, wx, wy, wz]
            self.imu = np.asarray([[v[0] * 1e-9, v[4], v[5], v[6],
                                    v[1], v[2], v[3]]
                                   for v in _read_csv_rows(ipath)])

        self.gt_ts = np.zeros(0)
        self.gt_poses = np.zeros((0, 7), np.float32)
        gpath = os.path.join(root, "state_groundtruth_estimate0", "data.csv")
        if os.path.isfile(gpath):
            rows = _read_csv_rows(gpath)
            self.gt_ts = np.asarray([v[0] * 1e-9 for v in rows])
            # csv px py pz qw qx qy qz -> [t, q wxyz]
            self.gt_poses = np.asarray([v[1:8] for v in rows], np.float32)
        return True

    def _length(self) -> int:
        return len(self.entries)

    def _grab(self, idx: int) -> Optional[FrameData]:
        if idx >= len(self.entries):
            return None
        ts_ns, name = self.entries[idx]
        t = ts_ns * 1e-9
        img = to_gray_f32(read_rgb_u8(os.path.join(self.root, "cam0", "data",
                                                   name)))
        right = None
        if len(self.t1):
            j = int(np.argmin(np.abs(self.t1 - ts_ns)))
            if abs(self.t1[j] - ts_ns) < 2_000_000:  # 2 ms
                right = to_gray_f32(read_rgb_u8(os.path.join(
                    self.root, "cam1", "data", self.entries1[j][1])))
        if self.rectifier is not None:
            # left is remapped for right-less frames too: self.cam is the
            # rectified pinhole
            img = self.rectifier.rectify_one(img, 0).numpy()
            if right is not None:
                right = self.rectifier.rectify_one(right, 1).numpy()
        gt = None
        if len(self.gt_ts):
            j = int(np.argmin(np.abs(self.gt_ts - t)))
            if abs(self.gt_ts[j] - t) <= 0.02:
                gt = self.gt_poses[j]
        imu = None
        if len(self.imu):
            t_prev = self.entries[idx - 1][0] * 1e-9 if idx > 0 else t - 0.05
            # inclusive lower bound: preintegration anchors on the first
            # sample (zero dt), so the boundary sample sits in both
            # adjacent windows
            sel = (self.imu[:, 0] >= t_prev) & (self.imu[:, 0] <= t)
            imu = self.imu[sel].copy()
            # body -> camera frame
            imu[:, 1:4] = imu[:, 1:4] @ self.R_cb.T
            imu[:, 4:7] = imu[:, 4:7] @ self.R_cb.T
        return FrameData(id=idx, timestamp=t, image=img, camera=self.cam,
                         image_right=right, camera_right=self.cam1,
                         stereo_baseline=self.baseline,
                         gt_pose=gt, imu=imu)


@DATASETS.register("euroc")
def _make_euroc() -> EuRoCDataset:
    return EuRoCDataset()
