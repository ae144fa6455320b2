"""SLAM systems ("models"): counterpart of ``gslam_tpu/models``.

Importing this package registers the five systems in
``gslam_tpu_torch.app.registry.SLAMS``:

* ``"keyframe"`` — :class:`~gslam_tpu_torch.models.keyframe_slam.
  KeyframeSLAM`: tracking against the local map, keyframe mapping,
  local BA, loop closure and relocalization (RGB-D, monocular, pyramid,
  visual-inertial; one frame a call or K a CUDA graph);
* ``"odometry"`` — :class:`~gslam_tpu_torch.models.odometry.
  FrameToFrameOdometry`: detect + match + PnP (or two-view) odometry;
* ``"stereo"`` — :class:`~gslam_tpu_torch.models.stereo.StereoSLAM`:
  KeyframeSLAM with depth from rectified left-right matching;
* ``"direct"`` — :class:`~gslam_tpu_torch.models.direct.
  DirectOdometry`: coarse-to-fine photometric (+ geometric) GN;
* ``"sfm"`` — :class:`~gslam_tpu_torch.models.sfm.GlobalSfM`: offline
  global structure from motion.

:mod:`~gslam_tpu_torch.models.graft` holds the fused tracking step
``track_forward``, :mod:`~gslam_tpu_torch.models.pipeline` the
messenger-wired ``SLAMPipeline``.  Each system runs on the CUDA card unless created with
``device="cpu"``.
"""

from gslam_tpu_torch.app.registry import SLAMS  # noqa: F401
from gslam_tpu_torch.models.keyframe_slam import (  # noqa: F401
    KeyframeSLAM, SLAMConfig,
)
from gslam_tpu_torch.models.odometry import FrameToFrameOdometry  # noqa: F401
from gslam_tpu_torch.models.stereo import StereoSLAM  # noqa: F401
from gslam_tpu_torch.models.direct import (  # noqa: F401
    DirectConfig, DirectOdometry,
)
from gslam_tpu_torch.models.sfm import GlobalSfM  # noqa: F401
