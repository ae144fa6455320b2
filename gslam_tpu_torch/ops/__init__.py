"""Device ops: the ORB-style frontend and the Hamming matchers.

Each op has a plain PyTorch version (the port of the jnp reference in
``gslam_tpu/ops``); the detector, the BRIEF sampler and the two matchers
also have hand-written CUDA kernels in :mod:`gslam_tpu_torch.ops.cuda`,
which the main path launches on CUDA tensors.
"""

from gslam_tpu_torch.ops.frontend import (  # noqa: F401
    Features, brief_descriptors, brief_pattern, compute_orientations,
    extract_features, extract_features_pyramid, fast_score, gaussian_blur,
    image_pyramid, nms, orientation_map, select_keypoints,
)
from gslam_tpu_torch.ops.matching import (  # noqa: F401
    hamming_matrix, match_descriptors, match_frames, unpack_descriptors,
)
