"""Rotated BRIEF-256 sampler: wrapper of ``csrc/brief.cu``.

Counterpart of ``gslam_tpu/ops/pallas/brief.py``
(``brief_descriptors_pallas``).  Plain version: ``brief_from_rotation``
of :mod:`gslam_tpu_torch.ops.frontend`.  As in the TPU wrapper, cos and
sin of the angles are computed outside the kernel, so the kernel and the
plain version see the same ``ca``/``sa`` and agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gslam_tpu_torch.ops.cuda import build
from gslam_tpu_torch.ops.frontend import (
    DESC_WORDS, brief_from_rotation, pattern_on,
)

launches = 0     # kernel launches since the last reset


@functools.cache
def _lib(flags: tuple = ()) -> ctypes.CDLL:
    """The brief library, built with ``flags`` (a tuning variant's
    ``-D`` macros) added."""
    lib = build.library("brief", flags)
    fn = lib.gslam_brief
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return lib


def brief(img_blur: torch.Tensor, uv: torch.Tensor, ca: torch.Tensor,
          sa: torch.Tensor) -> torch.Tensor:
    """(K, DESC_WORDS) int32 rotated-BRIEF words for keypoints ``uv``
    (K, 2) with angle cosines/sines ``ca``/``sa`` (K,), sampled from the
    blurred (H, W) float32 image: the plain version on CPU tensors, the
    kernel on CUDA ones."""
    global launches
    if img_blur.device.type == "cpu":
        return brief_from_rotation(img_blur, uv, ca, sa)
    K = uv.shape[0]
    build.check_tensor(img_blur, "img_blur", torch.float32, (None, None))
    build.check_tensor(uv, "uv", torch.float32, (K, 2))
    build.check_tensor(ca, "ca", torch.float32, (K,))
    build.check_tensor(sa, "sa", torch.float32, (K,))
    H, W = img_blur.shape
    out = torch.empty((K, DESC_WORDS), dtype=torch.int32,
                      device=img_blur.device)
    err = _lib().gslam_brief(img_blur.data_ptr(), uv.data_ptr(),
                             ca.data_ptr(), sa.data_ptr(),
                             pattern_on(img_blur.device).data_ptr(),
                             out.data_ptr(), K, H, W, build.stream_ptr())
    build.check_launch(err, "gslam_brief")
    launches += 1
    return out
