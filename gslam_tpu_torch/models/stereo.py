"""Stereo keyframe SLAM (the KITTI odometry path, BASELINE config #3).

Counterpart of ``gslam_tpu/models/stereo.py``: :class:`KeyframeSLAM`
with per-keypoint depth from rectified left-right descriptor matching
(:mod:`gslam_tpu_torch.ops.stereo`) instead of a depth image: metric
scale from the baseline, the same tracking, mapping and BA (B1, B2 on
both images; B4, B5, B6 as in KeyframeSLAM).

The JAX package overrides its ``_kp_depths(frame, feats)`` hook; the
port's keypoint depths are set in :meth:`KeyframeSLAM.
_set_keypoint_samples`, which ``track`` and ``track_batch``'s trigger
frame both call, so that is the method overridden here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.datasets.base import FrameData
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.models.loop_closure import LoopCloser
from gslam_tpu_torch.ops.frontend import Features
from gslam_tpu_torch.ops.stereo import match_stereo, stereo_depth


class StereoSLAM(KeyframeSLAM):
    def __init__(self, camera: Camera, config: Optional[SLAMConfig] = None,
                 max_disparity: float = 128.0, device="cuda",
                 uniforms: Optional[Callable[[], torch.Tensor]] = None):
        super().__init__(camera, config, device=device, uniforms=uniforms)
        self.max_disparity = max_disparity

    def _set_keypoint_samples(self, frame: FrameData, img: torch.Tensor,
                              feats: Features) -> None:
        if frame.image_right is None or frame.stereo_baseline <= 0:
            return super()._set_keypoint_samples(frame, img, feats)
        self._cur_kp_depth = self._stereo_depths(frame, feats)
        self._cur_kp_color = self._kp_colors(img, feats)

    def _stereo_depths(self, frame: FrameData, feats: Features
                       ) -> torch.Tensor:
        """(K,) depth of the left keypoints from the right image: 0 where
        no match passes the gate.  Counters ``slam/stereo/keypoints``
        (valid left keypoints) and ``slam/stereo/depths`` (those matched
        under the gate, so given a depth), one observation a frame each,
        summed on the device.  The right image is extracted at one level,
        as the JAX package's, through :meth:`KeyframeSLAM._extract` (the
        left image's graph where the left is single-scale too; counter
        ``slam/stereo/graph``)."""
        tm = self.timer
        with tm.section("slam/stereo"):
            right = torch.as_tensor(frame.image_right, device=self.device)
            feats_r = self._extract(right, "slam/stereo", n_levels=1)
            disp, ok = match_stereo(
                feats.desc, feats.valid, feats.uv, feats_r.desc,
                feats_r.valid, feats_r.uv, max_disparity=self.max_disparity)
            depth = stereo_depth(disp, ok, self.camera.fx,
                                 frame.stereo_baseline)
            depth = torch.where(torch.isfinite(depth), depth,
                                depth.new_zeros(()))
        tm.count("slam/stereo/keypoints", feats.valid.sum())
        tm.count("slam/stereo/depths", ok.sum())
        return depth


@SLAMS.register("stereo")
def _make_stereo(camera: Camera, device="cuda", **kw) -> StereoSLAM:
    """``SLAMS.create("stereo", camera, device=..., **SLAMConfig
    fields)``; a ``vocabulary`` attaches a stock :class:`LoopCloser`, as
    the JAX package's factory does."""
    voc = kw.pop("vocabulary", None)
    cfg = SLAMConfig(**kw) if kw else None
    slam = StereoSLAM(camera, cfg, device=device)
    if voc is not None:
        slam.loop_closer = LoopCloser(voc, slam.cfg.cap_frames,
                                      use_kernels=slam.cfg.use_kernels,
                                      timer=slam.timer)
    return slam
