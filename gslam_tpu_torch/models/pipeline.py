"""Messenger-wired SLAM pipeline (the reference's 3.x dataflow).

Counterpart of ``gslam_tpu/models/pipeline.py``.  The SLAM system
subscribes to the dataset frame topic and publishes current-frame and
map-update messages that evaluation and visualization consume:

    slam/curframe   {"id", "timestamp", "pose" (7,) cam->world numpy,
                     and the frame's stats row}
    slam/map        the MapArena (on keyframe insertion)
    slam/eos        final summary when the dataset signals end of stream

With :class:`~gslam_tpu_torch.datasets.base.DatasetPlayer` this is the
reference's wiring: player thread -> bus -> SLAM -> bus -> consumers.
``track`` runs on the frame subscriber's worker thread; the pose it
returns lives on the system's device and is copied to the host once per
frame.  A published arena is never written afterwards: the systems
replace the arena's tensors with new ones rather than writing into them.
A ``track`` that raises ends the run at that frame: no later frame is
tracked, and :meth:`SLAMPipeline.wait` raises the exception.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from gslam_tpu_torch.app.messenger import Messenger, messenger as global_bus
from gslam_tpu_torch.datasets.base import EOS_TOPIC, FRAME_TOPIC, FrameData

CURFRAME_TOPIC = "slam/curframe"
MAP_TOPIC = "slam/map"
SLAM_EOS_TOPIC = "slam/eos"


class SLAMPipeline:
    """Subscribes a SLAM system to the dataset topic (queued, ordered)."""

    def __init__(self, slam, bus: Optional[Messenger] = None,
                 queue_size: int = 8):
        self.slam = slam
        self.bus = bus or global_bus
        self.done = threading.Event()
        self._n_kf_last = -1
        self._sub_frame = self.bus.subscribe(FRAME_TOPIC, queue_size,
                                             self._on_frame)
        self._sub_eos = self.bus.subscribe(EOS_TOPIC, 0, self._on_eos)

    def _on_frame(self, frame: FrameData) -> None:
        pose = self.slam.track(frame)
        msg: Dict[str, Any] = {
            "id": frame.id,
            "timestamp": frame.timestamp,
            "pose": pose.cpu().numpy(),           # the one host copy
        }
        if self.slam.stats:
            msg.update(self.slam.stats[-1])
        self.bus.publish(CURFRAME_TOPIC, msg)
        arena = getattr(self.slam, "arena", None)
        if arena is not None:
            n_kf = int(arena.n_frames)
            if n_kf != self._n_kf_last:
                self._n_kf_last = n_kf
                self.bus.publish(MAP_TOPIC, arena)

    def _on_eos(self, msg: Any) -> None:
        # drain our own frame queue before declaring completion (raises,
        # on the player's thread, the exception of a failed track)
        self._sub_frame.flush(timeout=60.0)
        self.bus.publish(SLAM_EOS_TOPIC, {
            "frames": len(self.slam.trajectory),
            "positions": self.slam.positions(),
            "timestamps": np.asarray(self.slam.timestamps),
        })
        self.done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True once end of stream is handled, False after ``timeout``
        seconds; raises the exception of a frame whose ``track`` failed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.done.wait(0.01):
            if self._sub_frame.error is not None:
                raise self._sub_frame.error
            if deadline is not None and time.monotonic() >= deadline:
                return False
        return True

    def shutdown(self) -> None:
        self._sub_frame.shutdown()
        self._sub_eos.shutdown()
