"""The benchmark of gslam_tpu_torch: ``python3 -m slambench.run``."""
