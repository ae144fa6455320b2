"""Bundle adjustment (counterpart of ``gslam_tpu/opt``)."""
