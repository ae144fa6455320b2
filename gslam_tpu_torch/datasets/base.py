"""Frame container, dataset iteration and the dataset player.

Counterpart of ``gslam_tpu/datasets/base.py``: ``FrameData``,
``Dataset`` (open / grab_frame / iteration) and ``DatasetPlayer``, a
thread that publishes frames on a :class:`~gslam_tpu_torch.app.
messenger.Messenger` topic at a chosen rate (play / pause / step).
Frames are host-side numpy: a consumer moves what it needs to its
device.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator, Optional

import numpy as np

from gslam_tpu_torch.app.messenger import Messenger, messenger as global_bus
from gslam_tpu_torch.core.camera import Camera

#: topic the player publishes frames on
FRAME_TOPIC = "dataset/frame"
#: topic of the end-of-stream message ({"frames": n})
EOS_TOPIC = "dataset/eos"


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


class DatasetPlayer:
    """Playback thread: publishes frames on the bus at a chosen rate.

    The reference player's semantics: ``play`` / ``pause`` / ``step``;
    ``rate=0`` plays at full speed, ``rate=r`` at r times real time by
    the frames' timestamps.  At the end of the dataset it publishes
    ``{"frames": n}`` on :data:`EOS_TOPIC` and its thread ends.
    """

    def __init__(self, dataset: Dataset, bus: Optional[Messenger] = None,
                 rate: float = 0.0):
        self.dataset = dataset
        self.bus = bus or global_bus
        self.rate = rate
        self._playing = threading.Event()
        self._stop = threading.Event()
        self._step_req = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, playing: bool = True) -> "DatasetPlayer":
        if playing:
            self._playing.set()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def play(self) -> None:
        self._playing.set()

    def pause(self) -> None:
        self._playing.clear()

    def step(self) -> None:
        self._step_req.set()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread:
            self._thread.join(timeout)

    def _run(self) -> None:
        last_ts = None
        last_wall = None
        while not self._stop.is_set():
            if not (self._playing.is_set() or self._step_req.is_set()):
                time.sleep(0.005)
                continue
            self._step_req.clear()
            fr = self.dataset.grab_frame()
            if fr is None:
                self.bus.publish(EOS_TOPIC, {"frames": self.dataset._idx})
                return
            if self.rate > 0 and last_ts is not None:
                dt = (fr.timestamp - last_ts) / self.rate
                sleep = dt - (time.perf_counter() - last_wall)
                if sleep > 0:
                    time.sleep(sleep)
            last_ts = fr.timestamp
            last_wall = time.perf_counter()
            self.bus.publish(FRAME_TOPIC, fr)
