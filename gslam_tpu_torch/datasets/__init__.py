"""Datasets (counterpart of ``gslam_tpu/datasets``): the frame container,
the synthetic sequences and the file players, each registered under its
path extension for :func:`~gslam_tpu_torch.app.registry.open_dataset`.
Players are host-side numpy; images decode through the native library
(:mod:`gslam_tpu_torch.datasets.native_loader`)."""

from gslam_tpu_torch.datasets.base import Dataset, FrameData
from gslam_tpu_torch.datasets import synthetic  # ".synth"
from gslam_tpu_torch.datasets import tum_rgbd   # ".tumrgbd", ".tummono"
from gslam_tpu_torch.datasets import kitti      # ".kitti"
from gslam_tpu_torch.datasets import euroc      # ".euroc"
from gslam_tpu_torch.datasets import video      # ".cvmono", ".imgs", ...
from gslam_tpu_torch.datasets import dronemap   # ".dronemap", ".rtm"
from gslam_tpu_torch.app.registry import open_dataset

__all__ = ["Dataset", "FrameData", "open_dataset", "synthetic", "tum_rgbd",
           "kitti", "euroc", "video", "dronemap"]
