"""SO(3) as unit quaternions over (..., 4) tensors in (w, x, y, z) order.

Counterpart of ``gslam_tpu/core/so3.py``: the same formulas, the same
small-angle Taylor branches selected with ``torch.where`` on safe
operands, broadcasting over leading dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_identity(shape=(), dtype=torch.float32, device=None
                  ) -> torch.Tensor:
    """Identity quaternions (*shape, 4): (1, 0, 0, 0)."""
    q = torch.zeros((*shape, 4), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(
        _EPS)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product (broadcasts over leading dims)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate points v (..., 3) by q (..., 4): 2*(q_v x (q_v x v + w v))
    + v, two cross products."""
    w = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4), Taylor near 0."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2.clamp_min(_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < _EPS
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * phi], dim=-1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> axis-angle (..., 3), |result| <= pi."""
    q = quat_normalize(q)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = q[..., :1]
    qv = q[..., 1:]
    n2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    n = torch.sqrt(n2.clamp_min(_EPS * _EPS))
    small = n2 < _EPS
    angle = 2.0 * torch.atan2(n, w)
    k = torch.where(small, 2.0 / w.clamp_min(_EPS), angle / n)
    return k * qv


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> rotation matrices (..., 3, 3)."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(*m.shape[:-1], 3, 3)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4), Shepperd's branch-free variant: all four
    candidates, the one with the largest leading term selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 cand, 4)
    lead = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                       dim=-1)
    idx = torch.argmax(lead, dim=-1)                # first maximum
    best = torch.take_along_dim(
        cands, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2
    )[..., 0, :]
    return quat_normalize(best)
