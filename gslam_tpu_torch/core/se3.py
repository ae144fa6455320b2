"""SE(3) rigid transforms, packed (..., 7) = [t(3), q(4 wxyz)].

Counterpart of ``gslam_tpu/core/se3.py``: closed-form left Jacobian of
SO(3) with Taylor fallbacks for exp/log.
"""

from __future__ import annotations

import torch

from gslam_tpu_torch.core.so3 import (
    matrix_to_quat, quat_conj, quat_identity, quat_mul, quat_normalize,
    quat_rotate, quat_to_matrix, so3_exp, so3_log,
)

_EPS = 1e-8


def se3_identity(shape=(), dtype=torch.float32, device=None
                 ) -> torch.Tensor:
    """Identity transforms (*shape, 7): t = 0, q = (1, 0, 0, 0)."""
    t = torch.zeros((*shape, 3), dtype=dtype, device=device)
    return torch.cat([t, quat_identity(shape, dtype, device)], dim=-1)


def se3_t(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3]


def se3_q(T: torch.Tensor) -> torch.Tensor:
    return T[..., 3:7]


def se3_make(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, quat_normalize(q)], dim=-1)


def se3_mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Compose: (A*B) x = A (B x)."""
    tA, qA = A[..., :3], A[..., 3:7]
    tB, qB = B[..., :3], B[..., 3:7]
    return se3_make(tA + quat_rotate(qA, tB), quat_mul(qA, qB))


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    t, q = T[..., :3], T[..., 3:7]
    qi = quat_conj(q)
    return se3_make(-quat_rotate(qi, t), qi)


def se3_apply(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Act on points x (..., 3): R x + t."""
    return quat_rotate(T[..., 3:7], x) + T[..., :3]


def _hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> skew matrices (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        zero, -z, y,
        z, zero, -x,
        -y, x, zero,
    ], dim=-1).reshape(*v.shape[:-1], 3, 3)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """J_l(phi) (..., 3, 3): t = J_l(phi) rho in se3_exp."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2.clamp_min(_EPS * _EPS))
    K = _hat(phi)
    KK = K @ K
    small = theta2 < _EPS
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + a * K + b * KK


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2.clamp_min(_EPS * _EPS))
    K = _hat(phi)
    KK = K @ K
    small = theta2 < _EPS
    half = 0.5 * theta
    cot_term = half * torch.cos(half) / torch.sin(half).clamp_min(_EPS)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - cot_term) / theta2)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye - 0.5 * K + c * KK


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) = [rho, phi] -> SE3 (..., 7)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return se3_make(t, q)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE3 (..., 7) -> twist (..., 6) = [rho, phi]."""
    t, q = T[..., :3], T[..., 3:7]
    phi = so3_log(q)
    rho = (_so3_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_to_matrix(T: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> homogeneous matrices (..., 4, 4)."""
    top = torch.cat([quat_to_matrix(T[..., 3:7]), T[..., :3, None]], dim=-1)
    bottom = T.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        *T.shape[:-1], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def matrix_to_se3(M: torch.Tensor) -> torch.Tensor:
    return se3_make(M[..., :3, 3], matrix_to_quat(M[..., :3, :3]))
