"""BoW tree descent: wrapper of ``csrc/vocab.cu`` (B7).

Counterpart of ``gslam_tpu/ops/pallas/vocab.py``
(``transform_words_pallas``); plain version ``_transform_words`` of
:mod:`gslam_tpu_torch.ops.vocab`.  The word ids are integers: the kernel
equals the plain version exactly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gslam_tpu_torch.ops.cuda import build
from gslam_tpu_torch.ops.frontend import DESC_WORDS
from gslam_tpu_torch.ops.vocab import _level_offset, _transform_words

launches = 0         # B7 kernel launches since the last reset
MAX_K = (1 << 20) - 1   # the kernel packs the child index into 20 bits


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("vocab")
    fn = lib.gslam_transform_words
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2
    return lib


def transform_words_kernel(node_desc: torch.Tensor, desc: torch.Tensor,
                           valid: torch.Tensor, k: int, L: int
                           ) -> torch.Tensor:
    """(N,) int32 word ids of a complete k-ary tree of depth L, -1 where
    invalid, as :func:`~gslam_tpu_torch.ops.vocab._transform_words`
    computes them: the plain version on CPU tensors, the B7 kernel on
    CUDA ones."""
    global launches
    if desc.device.type == "cpu":
        return _transform_words(node_desc, desc, valid, k, L)
    N = desc.shape[0]
    if not (2 <= k <= MAX_K and L >= 1):
        raise ValueError(f"the descent kernel needs 2 <= k <= {MAX_K} and "
                         f"L >= 1, got k={k}, L={L}")
    build.check_tensor(node_desc, "node_desc", torch.int32,
                       (_level_offset(k, L + 1), DESC_WORDS))
    build.check_tensor(desc, "desc", torch.int32, (N, DESC_WORDS))
    build.check_tensor(valid, "valid", torch.bool, (N,))
    if N < 1:
        raise ValueError("the descent kernel needs N >= 1 descriptors")
    words = torch.empty(N, dtype=torch.int32, device=desc.device)
    err = _lib().gslam_transform_words(
        node_desc.data_ptr(), desc.data_ptr(), valid.data_ptr(), N, k, L,
        words.data_ptr(), build.stream_ptr())
    build.check_launch(err, "gslam_transform_words")
    launches += 1
    return words
