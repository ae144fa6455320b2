"""IMU preintegration (Forster-style, on-manifold).

Counterpart of ``gslam_tpu/core/imu.py``: the same recursions in the same
order, in float32 on the samples' device, one step per sample.  The JAX
package scans a window padded to a power-of-two bucket (its padded steps
are ``where(active)`` no-ops); here a step is a Python iteration, so a
caller passes the window unpadded and no step is wasted.  Padded rows
(``valid`` False, or a zero / negative / >= 0.1 s time step) are still
no-ops, so both give the same factor.  Nothing reads a value back to the
host.

* :func:`preintegrate` — light delta (dq / dv / dp / dt) for the
  gyro-aided motion model;
* :func:`preintegrate_full` — the full Forster et al. (TRO'16) factor:
  delta, 9x9 covariance of [dtheta, dv, dp] and first-order bias
  Jacobians, consumed by :mod:`gslam_tpu_torch.opt.vi`;
* :func:`compose_factors` — chain two preintegrated windows.

Samples are (M, 7) rows [t, ax, ay, az, wx, wy, wz] (body frame, m/s^2
and rad/s); gravity is the caller's (world frame).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gslam_tpu_torch.core.se3 import se3_make
from gslam_tpu_torch.core.so3 import (
    quat_conj, quat_identity, quat_mul, quat_rotate, quat_to_matrix,
    so3_exp,
)

GRAVITY = 9.81


def _hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1)], -2)


def _so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3): Jr(phi), Taylor-guarded near 0."""
    th2 = torch.sum(phi * phi, -1)
    th = torch.sqrt(th2)
    K = _hat(phi)
    K2 = K @ K
    small = th < 1e-5
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(ths)) / (ths * ths))
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (ths - torch.sin(ths)) / (ths ** 3))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - a[..., None, None] * K + b[..., None, None] * K2


class ImuDelta(NamedTuple):
    dq: torch.Tensor   # (4,) preintegrated rotation (body_i -> body_j)
    dv: torch.Tensor   # (3,) velocity change in frame i (gravity-free)
    dp: torch.Tensor   # (3,) position change in frame i (gravity-free)
    dt: torch.Tensor   # () elapsed seconds


class ImuFactor(NamedTuple):
    """Full preintegrated IMU factor between two frames (Forster TRO'16).

    Error state ordering is [dtheta, dv, dp] (9,).  The bias Jacobians
    are first-order sensitivities of the deltas to the biases, around
    the zero bias the window was integrated with."""

    dq: torch.Tensor      # (4,) preintegrated rotation body_i -> body_j
    dv: torch.Tensor      # (3,) velocity delta in frame i (gravity-free)
    dp: torch.Tensor      # (3,) position delta in frame i (gravity-free)
    dt: torch.Tensor      # () elapsed seconds
    cov: torch.Tensor     # (9, 9) covariance of [dtheta, dv, dp]
    J_R_bg: torch.Tensor  # (3, 3) d(dtheta)/d(bg)
    J_v_bg: torch.Tensor  # (3, 3) d(dv)/d(bg)
    J_v_ba: torch.Tensor  # (3, 3) d(dv)/d(ba)
    J_p_bg: torch.Tensor  # (3, 3) d(dp)/d(bg)
    J_p_ba: torch.Tensor  # (3, 3) d(dp)/d(ba)


def identity_factor(device="cpu") -> ImuFactor:
    """The factor of an empty window (zero dt, zero information)."""
    z3 = torch.zeros((3, 3), device=device)
    z = torch.zeros(3, device=device)
    return ImuFactor(dq=quat_identity(device=z.device), dv=z, dp=z,
                     dt=torch.zeros((), device=device),
                     cov=torch.zeros((9, 9), device=device),
                     J_R_bg=z3, J_v_bg=z3, J_v_ba=z3, J_p_bg=z3, J_p_ba=z3)


def _step_dts(samples: torch.Tensor, valid) -> torch.Tensor:
    """Per-sample time steps: successive timestamp differences (the first
    sample anchors with 0), zeroed where invalid or outside (0, 0.1) s."""
    t = samples[:, 0]
    dts = torch.diff(t, prepend=t[:1])
    ok = (dts > 0) & (dts < 0.1)
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, dts, torch.zeros_like(dts))


def preintegrate(samples: torch.Tensor, valid=None,
                 gyro_bias=None, accel_bias=None) -> ImuDelta:
    """Integrate an IMU window: samples (M, 7), valid (M,) bool (None:
    every row).  Midpoint rule: body acceleration rotated by the
    mid-step rotation."""
    acc = samples[:, 1:4]
    gyr = samples[:, 4:7]
    if accel_bias is not None:
        acc = acc - accel_bias
    if gyro_bias is not None:
        gyr = gyr - gyro_bias
    dts = _step_dts(samples, valid)
    q = quat_identity(dtype=samples.dtype, device=samples.device)
    v = samples.new_zeros(3)
    p = samples.new_zeros(3)
    for a, w, dt in zip(acc, gyr, dts):
        a_i = quat_rotate(quat_mul(q, so3_exp(0.5 * w * dt)), a)
        p = p + v * dt + 0.5 * a_i * dt * dt
        v = v + a_i * dt
        q = quat_mul(q, so3_exp(w * dt))
    return ImuDelta(dq=q, dv=v, dp=p, dt=dts.sum())


def preintegrate_full(samples: torch.Tensor, valid=None,
                      gyro_noise: float = 1.7e-4,
                      accel_noise: float = 2.0e-3) -> ImuFactor:
    """Forster preintegration with covariance and bias Jacobians.

    samples (M, 7), valid (M,) bool (None: every row).  Noise densities
    are continuous-time (rad/s/sqrt(Hz), m/s^2/sqrt(Hz)); per-sample
    variance = density^2 / dt.  Integrated with zero bias.  Everything
    that does not depend on the running state (the step rotations, right
    Jacobians, skew matrices and noise) is formed for all samples at
    once; the recursion then runs one step per sample, and an inactive
    step (dt = 0) keeps the state."""
    dev, dt_ = samples.device, samples.dtype
    acc = samples[:, 1:4]
    gyr = samples[:, 4:7]
    dts = _step_dts(samples, valid)
    active = dts > 0
    phi = gyr * dts[:, None]
    half_q = so3_exp(0.5 * phi)
    step_q = so3_exp(phi)
    dR_T = quat_to_matrix(step_q).transpose(-1, -2)
    Jr = _so3_right_jacobian(phi)
    ah = _hat(acc)
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    dt_s = torch.where(active, dts, torch.ones_like(dts))
    Qd = torch.diag_embed(torch.cat([
        (gyro_noise ** 2 / dt_s)[:, None].expand(-1, 3),
        (accel_noise ** 2 / dt_s)[:, None].expand(-1, 3)], -1))

    z3 = torch.zeros((3, 3), dtype=dt_, device=dev)
    q = quat_identity(dtype=samples.dtype, device=samples.device)
    v = samples.new_zeros(3)
    p = samples.new_zeros(3)
    cov = torch.zeros((9, 9), dtype=dt_, device=dev)
    JRg, Jvg, Jva, Jpg, Jpa = z3, z3, z3, z3, z3
    for k in range(samples.shape[0]):
        a, dt, on = acc[k], dts[k], active[k]
        # midpoint rotation for the accel transport
        R = quat_to_matrix(quat_mul(q, half_q[k]))
        Ra = R @ a
        Rah = R @ ah[k]

        # bias Jacobian recursion (Forster eqs. 69-71; position uses the
        # previous velocity / rotation Jacobians)
        Jpg_n = Jpg + Jvg * dt - 0.5 * (Rah @ JRg) * dt * dt
        Jpa_n = Jpa + Jva * dt - 0.5 * R * dt * dt
        Jvg_n = Jvg - (Rah @ JRg) * dt
        Jva_n = Jva - R * dt
        JRg_n = dR_T[k] @ JRg - Jr[k] * dt

        # covariance propagation on [dtheta, dv, dp]
        A = torch.zeros((9, 9), dtype=dt_, device=dev)
        A[0:3, 0:3] = dR_T[k]
        A[3:6, 0:3] = -Rah * dt
        A[3:6, 3:6] = eye3
        A[6:9, 0:3] = -0.5 * Rah * dt * dt
        A[6:9, 3:6] = eye3 * dt
        A[6:9, 6:9] = eye3
        B = torch.zeros((9, 6), dtype=dt_, device=dev)
        B[0:3, 0:3] = Jr[k] * dt
        B[3:6, 3:6] = R * dt
        B[6:9, 3:6] = 0.5 * R * dt * dt
        cov_n = A @ cov @ A.T + B @ Qd[k] @ B.T

        # state integration (mid-step rotation, as preintegrate)
        p_n = p + v * dt + 0.5 * Ra * dt * dt
        v_n = v + Ra * dt
        q_n = quat_mul(q, step_q[k])

        q, v, p, cov = (torch.where(on, q_n, q), torch.where(on, v_n, v),
                        torch.where(on, p_n, p), torch.where(on, cov_n, cov))
        JRg, Jvg, Jva, Jpg, Jpa = (
            torch.where(on, JRg_n, JRg), torch.where(on, Jvg_n, Jvg),
            torch.where(on, Jva_n, Jva), torch.where(on, Jpg_n, Jpg),
            torch.where(on, Jpa_n, Jpa))
    cov = 0.5 * (cov + cov.T)   # symmetry against float32 drift
    return ImuFactor(dq=q, dv=v, dp=p, dt=dts.sum(), cov=cov,
                     J_R_bg=JRg, J_v_bg=Jvg, J_v_ba=Jva,
                     J_p_bg=Jpg, J_p_ba=Jpa)


def compose_factors(a: ImuFactor, b: ImuFactor) -> ImuFactor:
    """Chain factor i->j (a) with j->k (b) into i->k.  Deltas compose
    exactly; covariance and bias Jacobians to first order."""
    Ra = quat_to_matrix(a.dq)
    dq = quat_mul(a.dq, b.dq)
    dv = a.dv + Ra @ b.dv
    dp = a.dp + a.dv * b.dt + Ra @ b.dp
    dt = a.dt + b.dt

    # error-state transport: d(x_ik)/d(x_ij) = F, d(x_ik)/d(x_jk) = G
    Rb_T = quat_to_matrix(b.dq).T
    eye3 = torch.eye(3, dtype=Ra.dtype, device=Ra.device)
    F = torch.zeros((9, 9), dtype=Ra.dtype, device=Ra.device)
    F[0:3, 0:3] = Rb_T
    F[3:6, 0:3] = -Ra @ _hat(b.dv)
    F[3:6, 3:6] = eye3
    F[6:9, 0:3] = -Ra @ _hat(b.dp)
    F[6:9, 3:6] = eye3 * b.dt
    F[6:9, 6:9] = eye3
    G = torch.zeros((9, 9), dtype=Ra.dtype, device=Ra.device)
    G[0:3, 0:3] = eye3
    G[3:6, 3:6] = Ra
    G[6:9, 6:9] = Ra
    cov = F @ a.cov @ F.T + G @ b.cov @ G.T

    J_R_bg = Rb_T @ a.J_R_bg + b.J_R_bg
    J_v_bg = a.J_v_bg + Ra @ b.J_v_bg - Ra @ _hat(b.dv) @ a.J_R_bg
    J_v_ba = a.J_v_ba + Ra @ b.J_v_ba
    J_p_bg = (a.J_p_bg + a.J_v_bg * b.dt + Ra @ b.J_p_bg
              - Ra @ _hat(b.dp) @ a.J_R_bg)
    J_p_ba = a.J_p_ba + a.J_v_ba * b.dt + Ra @ b.J_p_ba
    return ImuFactor(dq=dq, dv=dv, dp=dp, dt=dt, cov=cov,
                     J_R_bg=J_R_bg, J_v_bg=J_v_bg, J_v_ba=J_v_ba,
                     J_p_bg=J_p_bg, J_p_ba=J_p_ba)


def predict_pose(pose_wc_i: torch.Tensor, vel_w: torch.Tensor,
                 delta: ImuDelta, gravity_w=None) -> torch.Tensor:
    """Cam->world pose at j from pose / velocity at i and an IMU delta
    (IMU frame == camera frame).  ``gravity_w`` defaults to [0, 0, -g]
    (z-up world)."""
    if gravity_w is None:
        gravity_w = torch.tensor([0.0, 0.0, -GRAVITY],
                                 device=pose_wc_i.device)
    t_i = pose_wc_i[:3]
    q_i = pose_wc_i[3:7]
    dt = delta.dt
    p_j = (t_i + vel_w * dt + 0.5 * gravity_w * dt * dt
           + quat_rotate(q_i, delta.dp))
    return se3_make(p_j, quat_mul(q_i, delta.dq))


def imu_rotation_edge(delta: ImuDelta, weight: float = 1.0):
    """Pose-graph edge (i = new frame, j = old frame) from a gyro delta:
    (Z (7,), info (6,)).  Z = T_i<-j has rotation conj(dq) and no
    translation; the diagonal information weights only the rotation
    dims, so accelerometer error never reaches position."""
    dq = delta.dq
    Z = torch.cat([dq.new_zeros(3), quat_conj(dq)])
    info = torch.cat([dq.new_zeros(3), dq.new_full((3,), weight)])
    return Z, info
