"""Hamming matchers: wrappers of ``csrc/matcher.cu`` (B3) and
``csrc/gated.cu`` (B4).

Counterparts of ``gslam_tpu/ops/pallas/matcher.py``: B3
(``match_hamming_pallas``, top-2 with a mutual check; plain version
``hamming_top2``) and B4 (``match_hamming_gated_pallas``, top-2 among
the keypoints inside a pixel gate, no mutual check; plain version
``hamming_top2_gated``), both of :mod:`gslam_tpu_torch.ops.matching`.
The ratio / ``max_dist`` / mutual decisions stay in PyTorch
(``matches_from_top2``), as in the TPU wrappers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from gslam_tpu_torch.ops.cuda import build
from gslam_tpu_torch.ops.frontend import DESC_WORDS
from gslam_tpu_torch.ops.matching import (
    Matches, gate_squared, hamming_top2, hamming_top2_gated,
    matches_from_top2,
)

launches = 0         # B3 kernel launches since the last reset
gated_launches = 0   # B4 kernel launches since the last reset


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("matcher")
    lib.gslam_match_scratch.restype = ctypes.c_longlong
    lib.gslam_match_scratch.argtypes = [ctypes.c_int] * 2
    fn = lib.gslam_match_hamming
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 6
    return lib


@functools.cache
def _gated_lib(flags: tuple = ()) -> ctypes.CDLL:
    """The gated library, built with ``flags`` (a tuning variant's
    ``-D`` macros) added."""
    lib = build.library("gated", flags)
    fn = lib.gslam_match_gated
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
        ctypes.c_float] + [ctypes.c_void_p] * 4
    return lib


def hamming_top2_kernel(desc_a: torch.Tensor, valid_a: torch.Tensor,
                        desc_b: torch.Tensor, valid_b: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """(best, second, idx, back) as :func:`hamming_top2` computes them:
    the plain version on CPU tensors, the kernel on CUDA ones."""
    global launches
    if desc_a.device.type == "cpu":
        return hamming_top2(desc_a, valid_a, desc_b, valid_b)
    N, M = desc_a.shape[0], desc_b.shape[0]
    build.check_tensor(desc_a, "desc_a", torch.int32, (N, DESC_WORDS))
    build.check_tensor(desc_b, "desc_b", torch.int32, (M, DESC_WORDS))
    build.check_tensor(valid_a, "valid_a", torch.bool, (N,))
    build.check_tensor(valid_b, "valid_b", torch.bool, (M,))
    if not 1 <= N <= 65535 or M < 2:
        raise ValueError(f"the matcher kernel needs 1 <= N <= 65535 rows and"
                         f" M >= 2 columns, got N={N}, M={M}")
    dev = desc_a.device
    best = torch.empty(N, dtype=torch.float32, device=dev)
    second = torch.empty(N, dtype=torch.float32, device=dev)
    idx = torch.empty(N, dtype=torch.int32, device=dev)
    back = torch.empty(M, dtype=torch.int32, device=dev)
    lib = _lib()
    scratch = torch.empty(int(lib.gslam_match_scratch(N, M)),
                          dtype=torch.int32, device=dev)
    err = lib.gslam_match_hamming(
        desc_a.data_ptr(), valid_a.data_ptr(), desc_b.data_ptr(),
        valid_b.data_ptr(), N, M, best.data_ptr(), second.data_ptr(),
        idx.data_ptr(), back.data_ptr(), scratch.data_ptr(),
        build.stream_ptr())
    build.check_launch(err, "gslam_match_hamming")
    launches += 1
    return best, second, idx, back


def match_hamming(desc_a: torch.Tensor, valid_a: torch.Tensor,
                  desc_b: torch.Tensor, valid_b: torch.Tensor,
                  max_dist: float = 64.0, ratio: float = 0.8,
                  mutual: bool = True) -> Matches:
    """Drop-in for :func:`~gslam_tpu_torch.ops.matching.match_descriptors`
    through the matcher kernel."""
    return matches_from_top2(
        *hamming_top2_kernel(desc_a, valid_a, desc_b, valid_b), valid_a,
        max_dist=max_dist, ratio=ratio, mutual=mutual)


def gated_top2_kernel(desc_a: torch.Tensor, valid_a: torch.Tensor,
                      desc_b: torch.Tensor, valid_b: torch.Tensor,
                      uv_a: torch.Tensor, uv_b: torch.Tensor, gate2: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, second, idx) as :func:`hamming_top2_gated` computes them:
    the plain version on CPU tensors, the B4 kernel on CUDA ones."""
    global gated_launches
    if desc_a.device.type == "cpu":
        return hamming_top2_gated(desc_a, valid_a, desc_b, valid_b, uv_a,
                                  uv_b, gate2)
    N, M = desc_a.shape[0], desc_b.shape[0]
    build.check_tensor(desc_a, "desc_a", torch.int32, (N, DESC_WORDS))
    build.check_tensor(desc_b, "desc_b", torch.int32, (M, DESC_WORDS))
    build.check_tensor(valid_a, "valid_a", torch.bool, (N,))
    build.check_tensor(valid_b, "valid_b", torch.bool, (M,))
    build.check_tensor(uv_a, "uv_a", torch.float32, (N, 2))
    build.check_tensor(uv_b, "uv_b", torch.float32, (M, 2))
    if N < 1 or M < 1:
        raise ValueError(f"the gated matcher needs N, M >= 1, got N={N}, "
                         f"M={M}")
    dev = desc_a.device
    best = torch.empty(N, dtype=torch.float32, device=dev)
    second = torch.empty(N, dtype=torch.float32, device=dev)
    idx = torch.empty(N, dtype=torch.int32, device=dev)
    err = _gated_lib().gslam_match_gated(
        desc_a.data_ptr(), valid_a.data_ptr(), uv_a.data_ptr(),
        desc_b.data_ptr(), valid_b.data_ptr(), uv_b.data_ptr(), N, M,
        float(gate2), best.data_ptr(), second.data_ptr(), idx.data_ptr(),
        build.stream_ptr())
    build.check_launch(err, "gslam_match_gated")
    gated_launches += 1
    return best, second, idx


def match_hamming_gated(desc_a: torch.Tensor, valid_a: torch.Tensor,
                        desc_b: torch.Tensor, valid_b: torch.Tensor,
                        uv_a: torch.Tensor, uv_b: torch.Tensor,
                        gate_radius: float, max_dist: float = 64.0,
                        ratio: float = 0.9) -> Matches:
    """Drop-in for
    :func:`~gslam_tpu_torch.ops.matching.match_descriptors_gated` through
    the B4 kernel."""
    best, second, idx = gated_top2_kernel(
        desc_a, valid_a, desc_b, valid_b, uv_a.contiguous(),
        uv_b.contiguous(), gate_squared(gate_radius))
    return matches_from_top2(best, second, idx, None, valid_a,
                             max_dist=max_dist, ratio=ratio, mutual=False)
