"""SLAM models; so far the fused tracking step ``track_forward``."""
