"""The map arena (counterpart of ``gslam_tpu/map``)."""
