"""Optimization (counterpart of ``gslam_tpu/opt``): Schur-complement LM
bundle adjustment, robust kernels, the SE(3) / Sim(3) pose graph and
visual-inertial BA."""

from gslam_tpu_torch.opt.robust import (  # noqa: F401
    cauchy_weight, huber_weight, tukey_weight,
)
from gslam_tpu_torch.opt.ba import (  # noqa: F401
    BundleProblem, ba_cost, build_problem_from_arena, bundle_adjust,
    global_bundle_adjust, write_back_to_arena,
)
from gslam_tpu_torch.opt.pose_graph import (  # noqa: F401
    PoseGraph, optimize_pose_graph,
)
