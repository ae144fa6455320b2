"""gslam_tpu_torch — the SLAM engine on PyTorch and hand-written CUDA.

A port of ``gslam_tpu`` (JAX/XLA/Pallas) to PyTorch on an NVIDIA Hopper
card.  The layout mirrors the JAX package so that each counterpart is
easy to find:

* :mod:`gslam_tpu_torch.core` — SO(3)/SE(3) on quaternion 7-vectors and
  the pinhole camera;
* :mod:`gslam_tpu_torch.ops` — the ORB-style frontend and the Hamming
  matcher, with the detector, BRIEF sampler and matcher as CUDA kernels
  in :mod:`gslam_tpu_torch.ops.cuda` (sources in ``csrc/``);
* :mod:`gslam_tpu_torch.estimation` — batched RANSAC and P3P PnP;
* :mod:`gslam_tpu_torch.models` — the fused tracking step
  ``track_forward``;
* :mod:`gslam_tpu_torch.convert` — numpy <-> tensor conversion of the
  map slab, camera, features and matches, so that both packages compute
  on the same map.

Public layouts follow the JAX package: pixel coordinates are ``(x, y)``,
poses are ``[t(3), q(4, wxyz)]``, descriptors are ``(N, 8)`` 32-bit words
with bit ``32*w + j`` in word ``w`` (stored as int32 with the uint32 bit
pattern).  Nothing here imports JAX or ``gslam_tpu``.
"""

__version__ = "0.1.0"
