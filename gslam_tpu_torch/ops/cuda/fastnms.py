"""FAST-9/16 score + 3x3 NMS: wrapper of ``csrc/fastnms.cu``.

Counterpart of ``gslam_tpu/ops/pallas/fastnms.py``
(``fast_nms_raw_pallas``).  Plain version: ``fast_score`` + ``nms`` of
:mod:`gslam_tpu_torch.ops.frontend`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from gslam_tpu_torch.ops.cuda import build
from gslam_tpu_torch.ops.frontend import fast_score, nms

launches = 0     # kernel launches since the last reset


@functools.cache
def _lib(flags: tuple = ()) -> ctypes.CDLL:
    """The fastnms library, built with ``flags`` (a tuning variant's
    ``-D`` macros) added."""
    lib = build.library("fastnms", flags)
    fn = lib.gslam_fast_nms
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    return lib


def fast_nms_plain(img: torch.Tensor, threshold: float = 0.06,
                   arc: int = 9) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nms_score, raw_score) by the plain PyTorch version."""
    raw = fast_score(img, threshold, arc)
    return nms(raw), raw


def fast_nms_raw(img: torch.Tensor, threshold: float = 0.06,
                 arc: int = 9) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nms(fast_score(img)), fast_score(img)) for an (H, W) float32
    image: the plain version on a CPU tensor, the kernel on a CUDA one."""
    global launches
    if img.device.type == "cpu":
        return fast_nms_plain(img, threshold, arc)
    build.check_tensor(img, "img", torch.float32, (None, None))
    if arc not in (9, 12):
        raise ValueError(f"the FAST kernel is built for arc 9 or 12, got "
                         f"{arc}")
    H, W = img.shape
    nms_out = torch.empty_like(img)
    raw = torch.empty_like(img)
    err = _lib().gslam_fast_nms(img.data_ptr(), nms_out.data_ptr(),
                                raw.data_ptr(), H, W, float(threshold), arc,
                                build.stream_ptr())
    build.check_launch(err, "gslam_fast_nms")
    launches += 1
    return nms_out, raw
