"""Stereo keyframe SLAM (the KITTI odometry path, BASELINE config #3).

Counterpart of ``gslam_tpu/models/stereo.py``: :class:`KeyframeSLAM`
with per-keypoint depth from rectified left-right descriptor matching
(:mod:`gslam_tpu_torch.ops.stereo`) instead of a depth image: metric
scale from the baseline, the same tracking, mapping and BA (B1, B2 on
both images; B4, B5, B6 as in KeyframeSLAM).

With ``n_levels`` 1 the depths are the JAX package's bit for bit.  With
more levels the port departs from it: the right image goes through the
same pyramid as the left, and the stereo match is gated by octave, as
ORB-SLAM2's ``Frame::ComputeStereoMatches``; the JAX package extracts the
right image at one level.

The JAX package overrides its ``_kp_depths(frame, feats)`` hook; the
port's keypoint depths are set in :meth:`KeyframeSLAM.
_set_keypoint_samples`, which ``track`` and ``track_batch``'s trigger
frame both call, so that is the method overridden here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.datasets.base import FrameData
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.models.loop_closure import LoopCloser
from gslam_tpu_torch.ops.frontend import (
    Features, pyramid_levels, pyramid_shapes,
)
from gslam_tpu_torch.ops.stereo import match_stereo, stereo_depth


class StereoSLAM(KeyframeSLAM):
    def __init__(self, camera: Camera, config: Optional[SLAMConfig] = None,
                 max_disparity: float = 128.0, device="cuda",
                 uniforms: Optional[Callable[[], torch.Tensor]] = None):
        super().__init__(camera, config, device=device, uniforms=uniforms)
        self.max_disparity = max_disparity
        # the right image's stream on the card (None on the CPU, where the
        # stream context below is a no-op)
        self._right_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._levels: Dict[tuple, torch.Tensor] = {}

    def _set_keypoint_samples(self, frame: FrameData, img: torch.Tensor,
                              feats: Features) -> None:
        if frame.image_right is None or frame.stereo_baseline <= 0:
            return super()._set_keypoint_samples(frame, img, feats)
        self._cur_kp_depth = self._stereo_depths(frame, feats)
        self._cur_kp_color = self._kp_colors(img, feats)

    def _stereo_depths(self, frame: FrameData, feats: Features
                       ) -> torch.Tensor:
        """(K,) depth of the left keypoints from the right image: 0 where
        no match passes the gate.  The right image goes through the left
        image's extraction (``cfg``'s levels), on a second stream on the
        card (:meth:`_extract_right`, span ``slam/stereo/extract``); then
        ``match_stereo``, octave-gated with ``cfg.pyramid_scale`` where
        ``cfg.n_levels`` > 1, and the depth quotient (span
        ``slam/stereo/match``).  Counters ``slam/stereo/keypoints`` (valid
        left keypoints) and ``slam/stereo/depths`` (those matched under
        the gate, so given a depth), with more than one level also
        ``slam/stereo/coarse_keypoints`` and ``slam/stereo/coarse_depths``
        (the same on levels 1 and up), one observation a frame each,
        summed on the device."""
        tm = self.timer
        c = self.cfg
        with tm.section("slam/stereo"):
            feats_r = self._extract_right(frame)
            with tm.section("slam/stereo/match"):
                lev = self._slot_levels(frame.image_right.shape)
                disp, ok = match_stereo(
                    feats.desc, feats.valid, feats.uv, feats_r.desc,
                    feats_r.valid, feats_r.uv,
                    max_disparity=self.max_disparity, levels_l=lev,
                    levels_r=lev, scale=c.pyramid_scale)
                depth = stereo_depth(disp, ok, self.camera.fx,
                                     frame.stereo_baseline)
                depth = torch.where(torch.isfinite(depth), depth,
                                    depth.new_zeros(()))
        tm.count("slam/stereo/keypoints", feats.valid.sum())
        tm.count("slam/stereo/depths", ok.sum())
        if lev is not None:
            coarse = lev > 0
            tm.count("slam/stereo/coarse_keypoints",
                     (feats.valid & coarse).sum())
            tm.count("slam/stereo/coarse_depths", (ok & coarse).sum())
        return depth

    def _extract_right(self, frame: FrameData) -> Features:
        """The right image's features by :meth:`KeyframeSLAM._extract`
        (its own graph, keyed by the span ``slam/stereo``; counter
        ``slam/stereo/graph``).  On the card the upload and the extraction
        run on the system's second stream, which waits for nothing the
        main stream queued, so that they overlap the left image's
        extraction (PyTorch's copy from pageable memory waits for the
        stream it is queued on); the main stream waits for it before the
        match, and the features are marked as used there.  Span
        ``slam/stereo/extract``, opened on that stream."""
        side = self._right_stream
        with torch.cuda.stream(side), \
                self.timer.section("slam/stereo/extract"):
            right = torch.as_tensor(frame.image_right, device=self.device)
            feats_r = self._extract(right, "slam/stereo")
        if side is not None:
            main = torch.cuda.current_stream(self.device)
            for t in feats_r:
                t.record_stream(main)
            main.wait_stream(side)
        return feats_r

    def _slot_levels(self, shape) -> Optional[torch.Tensor]:
        """(max_kps,) int64 pyramid level of each keypoint slot of an
        image of ``shape`` on the device (made once a shape), or None with
        one level."""
        c = self.cfg
        if c.n_levels <= 1:
            return None
        lev = self._levels.get(tuple(shape))
        if lev is None:
            shapes = pyramid_shapes(*shape, c.n_levels, c.pyramid_scale)
            lev = self._levels[tuple(shape)] = torch.as_tensor(
                pyramid_levels(shapes, c.max_kps), device=self.device)
        return lev


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
