"""Intensity-centroid moments at keypoints: wrapper of ``csrc/orient.cu``.

Replaces no TPU kernel (the JAX package's orientation is plain jnp).
Plain version: ``centroid_moments`` of :mod:`gslam_tpu_torch.ops.frontend`
(the full-image separable moment filters of ``orientation_map`` read at
the keypoints by ``_gather2d``), which the kernel equals bit for bit.
As for BRIEF's cos and sin, ``atan2`` stays with the caller, so the
angle rounds as the plain path's does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from gslam_tpu_torch.ops.cuda import build
from gslam_tpu_torch.ops.frontend import centroid_moments as plain_moments

launches = 0     # kernel launches since the last reset


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("orient")
    fn = lib.gslam_orient
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return lib


def centroid_moments(img: torch.Tensor, uv: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m01, m10), each (K,) float32: the 31 x 31 patch moments of the
    (H, W) float32 image about keypoints ``uv`` (K, 2): the plain version
    on CPU tensors, the kernel on CUDA ones."""
    global launches
    if img.device.type == "cpu":
        return plain_moments(img, uv)
    K = uv.shape[0]
    build.check_tensor(img, "img", torch.float32, (None, None))
    build.check_tensor(uv, "uv", torch.float32, (K, 2))
    H, W = img.shape
    m01 = torch.empty((K,), dtype=torch.float32, device=img.device)
    m10 = torch.empty((K,), dtype=torch.float32, device=img.device)
    err = _lib().gslam_orient(img.data_ptr(), uv.data_ptr(), m01.data_ptr(),
                              m10.data_ptr(), K, H, W, build.stream_ptr())
    build.check_launch(err, "gslam_orient")
    launches += 1
    return m01, m10
