"""Evaluation (counterpart of ``gslam_tpu/eval``): trajectory accuracy
(association, Umeyama SE3 / Sim3 alignment, ATE RMSE, RPE, TUM / KITTI
trajectory files) and the final report (:mod:`.report`)."""

from gslam_tpu_torch.eval.trajectory import (  # noqa: F401
    TrajectoryMetrics, align_trajectory, associate, ate_rmse,
    evaluate_trajectory, rpe,
)
from gslam_tpu_torch.eval.report import EvalReport  # noqa: F401
