"""Sim(3) similarity transforms, packed (..., 8) = [t(3), q(4 wxyz), s].

Counterpart of ``gslam_tpu/core/sim3.py``.  Sim(3) is the pose type of
loop-closure pose-graph edges in ``sim3`` mode; metric maps keep s = 1
(the arena stores keyframe poses as Sim(3) with unit scale).  exp / log
use the closed-form W matrix (Strasdat's similarity left Jacobian) with
Taylor branches selected by ``torch.where`` on safe operands.
"""

from __future__ import annotations

import torch

from gslam_tpu_torch.core.se3 import _hat
from gslam_tpu_torch.core.so3 import (
    quat_conj, quat_mul, quat_normalize, quat_rotate, so3_exp, so3_log,
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


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W(phi, sigma) (..., 3, 3) with t = W rho in :func:`sim3_exp`:
    W = A I + B K + C KK, the coefficients functions of theta = |phi|
    and sigma (log scale), every branch Taylor-guarded."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2.clamp_min(_EPS * _EPS))
    sig = sigma[..., None]
    s = torch.exp(sig)
    K = _hat(phi)
    KK = K @ K

    sig_small = sig.abs() < 1e-5
    th_small = theta2 < _EPS
    sig_safe = torch.where(sig_small, torch.ones_like(sig), sig)

    # A = (s - 1) / sigma   (sigma -> 0: 1 + sigma/2 + sigma^2/6)
    A = torch.where(sig_small, 1.0 + sig / 2.0 + sig * sig / 6.0,
                    (s - 1.0) / sig_safe)
    # a = s sin(theta), b = s cos(theta), denom = sigma^2 + theta^2
    denom = (sig * sig + theta2).clamp_min(_EPS)
    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    B_gen = (a_ * sig + (1.0 - b_) * theta) / (theta * denom).clamp_min(_EPS)
    C_gen = (A - ((b_ - 1.0) * sig + a_ * theta) / denom) \
        / theta2.clamp_min(_EPS)
    # theta -> 0 limits (any sigma):
    #   B -> (sigma s - s + 1) / sigma^2          (sigma -> 0: 1/2 + sigma/3)
    #   C -> (s sigma^2/2 - s sigma + s - 1) / sigma^3    (-> 1/6 + sigma/8)
    B_th0 = torch.where(sig_small, 0.5 + sig / 3.0,
                        (sig * s - s + 1.0) / (sig_safe * sig_safe))
    C_th0 = torch.where(sig_small, 1.0 / 6.0 + sig / 8.0,
                        (s * sig * sig / 2.0 - s * sig + s - 1.0)
                        / (sig_safe ** 3))
    B = torch.where(th_small, B_th0, B_gen)
    C = torch.where(th_small, C_th0, C_gen)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return A * eye + B * K + C * KK


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent (..., 7) = [rho, phi, sigma] -> Sim3 (..., 8)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    t = (_sim3_W(phi, sigma) @ rho[..., None])[..., 0]
    return sim3_make(t, so3_exp(phi), torch.exp(sigma))


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """Sim3 (..., 8) -> tangent (..., 7) = [rho, phi, sigma].  A
    singular W gives non-finite rho (no exception, no host read)."""
    t, q, s = S[..., :3], S[..., 3:7], S[..., 7:8]
    phi = so3_log(q)
    sigma = torch.log(s.clamp_min(_EPS))
    rho = torch.linalg.solve_ex(_sim3_W(phi, sigma), t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma], dim=-1)
