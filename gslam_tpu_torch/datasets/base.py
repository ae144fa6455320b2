"""Frame container and dataset iteration.

Counterpart of ``FrameData`` and ``Dataset`` in
``gslam_tpu/datasets/base.py`` (open / grab_frame / iteration); the
messenger-driven player is not ported.  Frames are host-side numpy: a
consumer moves what it needs to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from gslam_tpu_torch.core.camera import Camera


@dataclasses.dataclass
class FrameData:
    """One dataset frame: images, calibration, timestamp, and ground
    truth / IMU where present."""

    id: int
    timestamp: float
    image: np.ndarray                     # (H, W) gray float32 [0,1]
    camera: Camera
    color: Optional[np.ndarray] = None    # (H, W, 3) uint8 RGB
    depth: Optional[np.ndarray] = None    # (H, W) float32 meters
    image_right: Optional[np.ndarray] = None   # stereo right gray
    camera_right: Optional[Camera] = None
    stereo_baseline: float = 0.0          # meters (right cam at +x)
    gt_pose: Optional[np.ndarray] = None  # (7,) SE3 cam->world [t, q wxyz]
    imu: Optional[np.ndarray] = None      # (M, 7) [t, ax, ay, az, wx, wy, wz]
    gps: Optional[np.ndarray] = None      # (4,) [t, lat, lon, alt]


class Dataset:
    """Abstract dataset: subclasses implement _open / _grab / _length."""

    def __init__(self):
        self._opened = False
        self._idx = 0

    def open(self, path: str) -> bool:
        self._opened = self._open(path)
        self._idx = 0
        return self._opened

    def is_opened(self) -> bool:
        return self._opened

    def grab_frame(self) -> Optional[FrameData]:
        if not self._opened:
            return None
        fr = self._grab(self._idx)
        if fr is not None:
            self._idx += 1
        return fr

    def __len__(self) -> int:
        return self._length()

    def __iter__(self) -> Iterator[FrameData]:
        while True:
            fr = self.grab_frame()
            if fr is None:
                return
            yield fr

    def _open(self, path: str) -> bool:
        raise NotImplementedError

    def _grab(self, idx: int) -> Optional[FrameData]:
        raise NotImplementedError

    def _length(self) -> int:
        raise NotImplementedError
