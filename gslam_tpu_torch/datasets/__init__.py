"""Datasets (counterpart of ``gslam_tpu/datasets``)."""
