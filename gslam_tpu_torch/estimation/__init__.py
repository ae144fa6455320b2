"""Robust estimation: batched RANSAC, P3P / DLT PnP with GN refinement,
two-view geometry (essential, fundamental and homography matrices,
triangulation, the H / E bootstrap), Umeyama alignment and the RANSAC
similarity, affine and plane fits.
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
from gslam_tpu_torch.estimation.alignment import (  # noqa: F401
    find_affine3d, find_plane, find_sim3, umeyama_alignment,
)
