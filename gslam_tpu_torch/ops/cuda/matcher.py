"""Hamming matcher with top-2 and mutual check: wrapper of
``csrc/matcher.cu``.

Counterpart of ``gslam_tpu/ops/pallas/matcher.py``
(``match_hamming_pallas``).  Plain version: ``hamming_top2`` of
:mod:`gslam_tpu_torch.ops.matching`; the ratio / ``max_dist`` / mutual
decisions stay in PyTorch (``matches_from_top2``), as in the TPU
wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from gslam_tpu_torch.ops.cuda import build
from gslam_tpu_torch.ops.frontend import DESC_WORDS
from gslam_tpu_torch.ops.matching import (
    Matches, hamming_top2, matches_from_top2,
)

launches = 0     # kernel launches since the last reset


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("matcher")
    fn = lib.gslam_match_hamming
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 6
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
    keys = torch.empty(M, dtype=torch.int32, device=dev)
    err = _lib().gslam_match_hamming(
        desc_a.data_ptr(), valid_a.data_ptr(), desc_b.data_ptr(),
        valid_b.data_ptr(), N, M, best.data_ptr(), second.data_ptr(),
        idx.data_ptr(), back.data_ptr(), keys.data_ptr(), build.stream_ptr())
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
