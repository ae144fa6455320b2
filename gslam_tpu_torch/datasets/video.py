"""Video-file and image-folder datasets.

Counterpart of ``gslam_tpu/datasets/video.py``: any video file (decoded
by cv2, or imageio where cv2 is missing) or a directory of images, with
the camera from a sibling ``calib.txt`` ("fx fy cx cy [k1 k2 p1 p2 k3]")
or a field-of-view default.  Registered extensions: cvmono, mp4, avi,
mov, imgs.  Folder images decode through the native library.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from gslam_tpu_torch.app.registry import DATASETS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.image import to_gray_f32
from gslam_tpu_torch.datasets.base import Dataset, FrameData
from gslam_tpu_torch.datasets.native_loader import read_rgb_u8


def _camera_for(root: str, W: int, H: int) -> Camera:
    cpath = os.path.join(root, "calib.txt")
    if os.path.isfile(cpath):
        with open(cpath) as f:
            v = [float(x) for x in f.read().split()]
        if len(v) >= 9:
            return Camera.opencv(W, H, *v[:9])
        if len(v) >= 4:
            return Camera.pinhole(W, H, *v[:4])
    return Camera.from_fov(W, H, 65.0)


class VideoDataset(Dataset):
    """One video file; frames timestamped by its frame rate."""

    def _open(self, path: str) -> bool:
        if path.endswith(".cvmono"):
            # a .cvmono file holds the video's path
            with open(path) as f:
                target = f.read().strip()
            if not os.path.isabs(target):
                target = os.path.join(os.path.dirname(path), target)
        else:
            target = path
        if not os.path.isfile(target):
            return False
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            self.cap = cv2.VideoCapture(target)
            if not self.cap.isOpened():
                return False
            self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
            self.n = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
            W = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            H = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self._read = self._read_cv2
        else:
            try:
                import imageio
            except ImportError:
                raise RuntimeError(f"decoding {target} needs cv2 or imageio, "
                                   "and neither is installed") from None
            self.cap = imageio.get_reader(target)
            self.fps = float(self.cap.get_meta_data().get("fps") or 30.0)
            n = self.cap.get_length()
            self.n = int(n) if np.isfinite(n) else 0   # a stream: unknown
            H, W = self.cap.get_data(0).shape[:2]
            self._frames = iter(self.cap)
            self._read = self._read_imageio
        self.camera = _camera_for(os.path.dirname(target), W, H)
        return True

    def _read_cv2(self) -> Optional[np.ndarray]:
        ok, frame = self.cap.read()
        return frame[..., ::-1] if ok else None    # BGR -> RGB

    def _read_imageio(self) -> Optional[np.ndarray]:
        frame = next(self._frames, None)
        return None if frame is None else np.asarray(frame)[..., :3]

    def _length(self) -> int:
        return self.n

    def _grab(self, idx: int) -> Optional[FrameData]:
        rgb = self._read()
        if rgb is None:
            return None
        return FrameData(id=idx, timestamp=idx / self.fps,
                         image=to_gray_f32(rgb), camera=self.camera,
                         color=np.ascontiguousarray(rgb))


class ImageFolderDataset(Dataset):
    """Directory of images sorted by name; ``<dir>.imgs`` or the dir."""

    def _open(self, path: str) -> bool:
        root = path[:-len(".imgs")] if path.endswith(".imgs") else path
        if not os.path.isdir(root):
            return False
        pats = ("*.png", "*.jpg", "*.jpeg", "*.bmp", "*.ppm", "*.pgm")
        self.files = sorted(f for p in pats
                            for f in glob.glob(os.path.join(root, p)))
        if not self.files:
            return False
        H, W = read_rgb_u8(self.files[0]).shape[:2]
        self.camera = _camera_for(root, W, H)
        return True

    def _length(self) -> int:
        return len(self.files)

    def _grab(self, idx: int) -> Optional[FrameData]:
        if idx >= len(self.files):
            return None
        arr = read_rgb_u8(self.files[idx])
        return FrameData(id=idx, timestamp=idx / 30.0,
                         image=to_gray_f32(arr), camera=self.camera,
                         color=arr if arr.ndim == 3 else None)


@DATASETS.register("cvmono")
def _make_cvmono() -> VideoDataset:
    return VideoDataset()


for _ext in ("mp4", "avi", "mov"):
    DATASETS.register(_ext)(VideoDataset)

DATASETS.register("imgs")(ImageFolderDataset)
