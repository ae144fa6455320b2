"""Trajectory evaluation (counterpart of ``gslam_tpu/eval``)."""
