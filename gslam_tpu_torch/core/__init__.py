"""Geometry: SO(3)/SE(3)/Sim(3) on quaternions, the lens models,
undistortion and rectification, image helpers, geodesy and IMU
preintegration.

Conventions, as in the JAX package: quaternions (..., 4) in (w, x, y,
z) order; SE3 (..., 7) = [t, q]; Sim3 (..., 8) = [t, q, s]; twists
[rho, phi] (translation first); transforms act on the left, y = T * x.
"""

from gslam_tpu_torch.core import camera, gps, image, se3, sim3, so3  # noqa: F401
from gslam_tpu_torch.core.so3 import (  # noqa: F401
    matrix_to_quat, quat_conj, quat_identity, quat_mul, quat_normalize,
    quat_rotate, quat_to_matrix, so3_exp, so3_log,
)
from gslam_tpu_torch.core.se3 import (  # noqa: F401
    matrix_to_se3, se3_apply, se3_exp, se3_identity, se3_inverse, se3_log,
    se3_mul, se3_to_matrix,
)
from gslam_tpu_torch.core.sim3 import (  # noqa: F401
    sim3_apply, sim3_exp, sim3_from_se3, sim3_identity, sim3_inverse,
    sim3_log, sim3_mul, sim3_to_se3,
)
