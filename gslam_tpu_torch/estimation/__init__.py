"""Robust estimation: batched RANSAC, P3P / DLT PnP with GN refinement,
two-view geometry (essential, fundamental and homography matrices,
triangulation, the H / E bootstrap) and Umeyama alignment.

The JAX package's ``find_sim3``, ``find_affine3d`` and ``find_plane``
are not ported yet (ROADMAP Queue A item 18).
"""

from gslam_tpu_torch.estimation.ransac import (  # noqa: F401
    num_hypotheses, ransac_sample_indices, run_ransac,
)
from gslam_tpu_torch.estimation.epipolar import (  # noqa: F401
    decompose_essential, essential_from_rt, find_essential, find_fundamental,
    sampson_distance, triangulate,
)
from gslam_tpu_torch.estimation.homography import find_homography  # noqa: F401
from gslam_tpu_torch.estimation.pnp import find_pnp_ransac  # noqa: F401
from gslam_tpu_torch.estimation.alignment import umeyama_alignment  # noqa: F401
