"""Sim(3) similarity transforms, packed (..., 8) = [t(3), q(4 wxyz), s].

Counterpart of the group operations of ``gslam_tpu/core/sim3.py``
(``sim3_exp`` / ``sim3_log`` come with loop closure).  Metric maps keep
s = 1: the arena stores keyframe poses as Sim(3) with unit scale.
"""

from __future__ import annotations

import torch

from gslam_tpu_torch.core.so3 import (
    quat_conj, quat_mul, quat_normalize, quat_rotate,
)
from gslam_tpu_torch.utils.platform import require_device

_EPS = 1e-8


def sim3_identity(shape=(), dtype=torch.float32, device="cuda"
                  ) -> torch.Tensor:
    """Identities of ``shape`` on ``device`` (the card unless the caller
    asks for the CPU)."""
    out = torch.zeros((*shape, 8), dtype=dtype,
                      device=require_device(device))
    out[..., 3] = 1.0
    out[..., 7] = 1.0
    return out


def sim3_make(t: torch.Tensor, q: torch.Tensor, s: torch.Tensor
              ) -> torch.Tensor:
    return torch.cat([t, quat_normalize(q), s], dim=-1)


def sim3_from_se3(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([T, T.new_ones((*T.shape[:-1], 1))], dim=-1)


def sim3_to_se3(S: torch.Tensor) -> torch.Tensor:
    """Drop scale (the caller decides whether to bake it into t)."""
    return S[..., :7]


def sim3_mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(A*B) x = A (B x) where S x = s R x + t."""
    tA, qA, sA = A[..., :3], A[..., 3:7], A[..., 7:8]
    tB, qB, sB = B[..., :3], B[..., 3:7], B[..., 7:8]
    return sim3_make(tA + sA * quat_rotate(qA, tB), quat_mul(qA, qB),
                     sA * sB)


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    t, q, s = S[..., :3], S[..., 3:7], S[..., 7:8]
    qi = quat_conj(q)
    si = 1.0 / s.clamp_min(_EPS)
    return sim3_make(-si * quat_rotate(qi, t), qi, si)


def sim3_apply(S: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return S[..., 7:8] * quat_rotate(S[..., 3:7], x) + S[..., :3]
