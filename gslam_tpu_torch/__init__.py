"""gslam_tpu_torch — the SLAM engine on PyTorch and hand-written CUDA.

A port of ``gslam_tpu`` (JAX/XLA/Pallas) to PyTorch on an NVIDIA Hopper
card.  The layout mirrors the JAX package so that each counterpart is
easy to find:

* :mod:`gslam_tpu_torch.core` — SO(3)/SE(3) on quaternion 7-vectors,
  Sim(3) with exp / log, the pinhole, ATAN, OpenCV and OCAM lens models,
  undistortion and stereo rectification, image helpers, WGS84 geodesy and
  IMU preintegration;
* :mod:`gslam_tpu_torch.ops` — the ORB-style frontend (single-scale and
  pyramid), the Hamming matchers (plain, projection-gated and word-gated)
  and the bag-of-words vocabulary, with the detector, BRIEF sampler, both
  matchers and the vocabulary tree descent as CUDA kernels in
  :mod:`gslam_tpu_torch.ops.cuda` (sources in ``csrc/``);
* :mod:`gslam_tpu_torch.estimation` — batched RANSAC, P3P and DLT PnP,
  two-view geometry (essential, fundamental and homography matrices,
  triangulation, the H / E bootstrap) and Umeyama alignment;
* :mod:`gslam_tpu_torch.map` — the fixed-capacity map arena;
* :mod:`gslam_tpu_torch.opt` — Schur-complement LM bundle adjustment
  (local and global), with the Schur reduction and the cost as CUDA
  kernels, visual-inertial BA and initialization, and the SE(3) / Sim(3)
  pose graph;
* :mod:`gslam_tpu_torch.models` — the fused tracking step
  ``track_forward``, ``KeyframeSLAM`` (RGB-D and monocular, with or
  without IMU, one frame a call or K a dispatch, the K-frame body one
  CUDA graph on the card) and its ``LoopCloser`` (loop closure and
  relocalization);
* :mod:`gslam_tpu_torch.datasets`, :mod:`gslam_tpu_torch.app`,
  :mod:`gslam_tpu_torch.eval` — the synthetic sequences and the TUM RGB-D
  / monoVO, KITTI, EuRoC, image-folder, video and drone-map players,
  opened by extension through ``app.registry.open_dataset`` and decoding
  through the native C library (``datasets/native_loader.py``); ATE /
  RPE, the TUM / KITTI trajectory files and the evaluation report;
* :mod:`gslam_tpu_torch.app` — the ``gslam``-style CLI (``python -m
  gslam_tpu_torch {play,eval,viz,bench,tests}``), the Svar config, the
  messenger bus (with :mod:`~gslam_tpu_torch.models.pipeline` and the
  dataset player) and the HTML viewer; :mod:`gslam_tpu_torch.bench`, the
  benchmark line, and :mod:`gslam_tpu_torch.graft_entry`, the step with
  its example and the multi-rank dry run;
* :mod:`gslam_tpu_torch.convert` — numpy <-> tensor conversion of the
  map (slab, arena, BA and VI problems, IMU factors, pose graph),
  vocabulary, camera, features and matches, so that both packages compute
  on the same map.

Public layouts follow the JAX package: pixel coordinates are ``(x, y)``,
poses are ``[t(3), q(4, wxyz)]``, descriptors are ``(N, 8)`` 32-bit words
with bit ``32*w + j`` in word ``w`` (stored as int32 with the uint32 bit
pattern).  Nothing here imports JAX or ``gslam_tpu``.
"""

__version__ = "0.1.0"
