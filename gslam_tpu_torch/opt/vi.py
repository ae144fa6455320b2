"""Visual-inertial bundle adjustment and visual-inertial initialization.

Counterpart of ``gslam_tpu/opt/vi.py``:

* :func:`vi_bundle_adjust` — joint LM over keyframe poses, per-keyframe
  world velocities, shared gyro / accel biases and landmarks.  The
  vision term is :mod:`gslam_tpu_torch.opt.ba`'s Schur-reduced system
  (the B5 kernel per iteration and the B6 cost kernel with
  ``use_kernels``, their plain versions otherwise); preintegrated IMU
  factors (:class:`gslam_tpu_torch.core.imu.ImuFactor`) couple
  consecutive keyframes on the reduced camera system, which is exact
  since they involve no landmarks.  Each factor's (9, 24 + NG) residual
  Jacobian is ``torch.func.jacfwd`` of the residual at the
  linearization point, under ``torch.func.vmap`` over the factors; the
  blocks are added into H and b with ``index_put_(accumulate=True)``
  (deterministic on the card).  The LM loop reads nothing back to the
  host: a failed Cholesky factor gives a NaN step, which the accept
  test rejects (as the JAX package's ``cho_solve`` does).
* :func:`estimate_gravity_velocity` — linear VI alignment (VINS-style)
  on the host in float64, as the JAX package solves it.
* :func:`gravity_align_rotation` — world rotation taking the gravity
  estimate to -z.

State layout of the normal equations: [xi (6C) | vel (3C) | bg 3 | ba 3
(| dgravity 2)], left-multiplicative SE3 twists on T_cw (as opt.ba).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from gslam_tpu_torch.core.imu import GRAVITY, ImuFactor
from gslam_tpu_torch.core.se3 import se3_exp, se3_mul
from gslam_tpu_torch.core.so3 import quat_mul, quat_to_matrix, so3_exp
from gslam_tpu_torch.opt.ba import (
    BundleProblem, ba_cost, schur_reduce, schur_wt_dxc,
)


class ViProblem(NamedTuple):
    """Visual-inertial window: vision problem + IMU chain."""

    vision: BundleProblem     # poses are T_cw == T_bw (body == camera)
    vel: torch.Tensor         # (C, 3) world-frame velocity per keyframe
    pair_i: torch.Tensor      # (K,) int32 cam index of factor start
    pair_j: torch.Tensor      # (K,) int32 cam index of factor end
    pair_valid: torch.Tensor  # (K,) bool
    imu: ImuFactor            # stacked (K, ...) preintegrated factors
    gravity_w: torch.Tensor   # (3,) world gravity
    bias_g: torch.Tensor      # (3,) current gyro bias estimate
    bias_a: torch.Tensor      # (3,) current accel bias estimate


def _body_pose(pose_cw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """T_cw (..., 7) -> (R_wb (..., 3, 3), p_wb (..., 3))."""
    R_wb = quat_to_matrix(pose_cw[..., 3:7]).transpose(-1, -2)
    p_wb = -torch.einsum("...ij,...j->...i", R_wb, pose_cw[..., :3])
    return R_wb, p_wb


def so3_log_mat(R: torch.Tensor) -> torch.Tensor:
    """Log map of one rotation matrix -> (3,) axis-angle, finite under
    forward-mode AD at the identity (atan2 of ||vee(R - R^T)|| with the
    double-where guard)."""
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])          # 2 sin(th) * axis
    s2 = torch.sum(w * w)                         # 4 sin^2(th)
    small = s2 < 1e-12
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    c = R[0, 0] + R[1, 1] + R[2, 2] - 1.0         # 2 cos(th)
    th = torch.atan2(s, c)
    scale = torch.where(small, 0.5 + s2 / 48.0, th / s)
    return w * scale


def _imu_residual(pose_i, pose_j, v_i, v_j, bg, ba, f: ImuFactor,
                  g_w) -> torch.Tensor:
    """(9,) Forster residual [r_R, r_v, r_p] of one factor."""
    R_i, p_i = _body_pose(pose_i)
    R_j, p_j = _body_pose(pose_j)
    dt = f.dt
    # bias-corrected deltas (first order around the zero integration bias)
    dq_c = quat_mul(f.dq, so3_exp(f.J_R_bg @ bg))
    dv_c = f.dv + f.J_v_bg @ bg + f.J_v_ba @ ba
    dp_c = f.dp + f.J_p_bg @ bg + f.J_p_ba @ ba
    dR_c = quat_to_matrix(dq_c)
    r_R = so3_log_mat(dR_c.T @ (R_i.T @ R_j))
    r_v = R_i.T @ (v_j - v_i - g_w * dt) - dv_c
    r_p = R_i.T @ (p_j - p_i - v_i * dt - 0.5 * g_w * dt * dt) - dp_c
    return torch.cat([r_R, r_v, r_p])


def _factor_info(cov: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """(K, 9, 9) information inv(cov + floor); zero-dt factors get 0.
    ``inv_ex``: no error check, so no host read."""
    eye = torch.eye(9, dtype=cov.dtype, device=cov.device)
    W, _ = torch.linalg.inv_ex(cov + 1e-10 * eye)
    return torch.where(dt[:, None, None] > 0, W, torch.zeros_like(W))


def vi_bundle_adjust(problem: ViProblem, iters: int = 8,
                     lm_lambda0: float = 1e-4, huber_delta: float = 0.01,
                     bias_prior: float = 1e4, warm_start: int = 2,
                     refine_gravity: bool = False, use_kernels: bool = False
                     ) -> Tuple[ViProblem, torch.Tensor]:
    """Joint visual-inertial LM.  Returns (updated problem, costs): costs
    (iters + 1,) total chi2 (robust vision + IMU) per iteration.

    The first ``warm_start`` iterations update only velocities and
    biases with poses and landmarks held.  ``refine_gravity`` adds a
    2-dof tangent perturbation of the gravity direction (magnitude
    fixed).  ``use_kernels`` routes the Schur reduction and the vision
    cost through the B5 / B6 kernels (their plain versions on CPU
    tensors; at most 32 cameras, see ``opt.ba.resolve_ba_kernels``)."""
    vis = problem.vision
    dev = vis.cam_pose.device
    C = vis.cam_pose.shape[0]
    NG = 2 if refine_gravity else 0
    N = 9 * C + 6 + NG

    cam_free = ~vis.cam_fixed
    pt_free = ~vis.point_fixed
    g_w = problem.gravity_w
    # orthonormal basis of the plane normal to g (the 2-dof update)
    g_dir = g_w / torch.linalg.vector_norm(g_w).clamp_min(1e-9)
    eye3 = torch.eye(3, device=dev)
    ref = torch.where(g_dir[0].abs() < 0.9, eye3[0], eye3[1])
    b1 = torch.linalg.cross(g_dir, ref)
    b1 = b1 / torch.linalg.vector_norm(b1).clamp_min(1e-9)
    b2 = torch.linalg.cross(g_dir, b1)
    g_basis = torch.stack([b1, b2], 1)            # (3, 2)
    g_mag = torch.linalg.vector_norm(g_w)

    def gravity_of(dg):
        """Perturbed gravity: rotate the direction, keep the magnitude."""
        if NG == 0:
            return g_w
        d = g_dir + g_basis @ dg
        return g_mag * d / torch.linalg.vector_norm(d).clamp_min(1e-9)

    imu = problem.imu
    infos = _factor_info(imu.cov, imu.dt) * problem.pair_valid[:, None, None]

    # local-parameter index map per factor:
    # [xi_i, xi_j, v_i, v_j, bg, ba (, dgravity)]; invalid pairs clip to
    # index 0, and their zero information leaves H and b unchanged
    pi = problem.pair_i.clamp_min(0).long()
    pj = problem.pair_j.clamp_min(0).long()
    a6 = torch.arange(6, device=dev)
    a3 = torch.arange(3, device=dev)
    idx = torch.cat([
        6 * pi[:, None] + a6, 6 * pj[:, None] + a6,
        6 * C + 3 * pi[:, None] + a3, 6 * C + 3 * pj[:, None] + a3,
        (9 * C + a3).expand(pi.shape[0], 3),
        (9 * C + 3 + a3).expand(pi.shape[0], 3),
        (9 * C + 6 + torch.arange(NG, device=dev)).expand(pi.shape[0], NG),
    ], 1)                                          # (K, 24 + NG)

    def residual_fn(bg, ba, dg):
        """One factor's residual as a function of its local tangent z."""
        def res(z, p_i0, p_j0, v_i0, v_j0, f):
            g = gravity_of(dg + z[24:24 + NG]) if NG else g_w
            return _imu_residual(
                se3_mul(se3_exp(z[:6]), p_i0), se3_mul(se3_exp(z[6:12]), p_j0),
                v_i0 + z[12:15], v_j0 + z[15:18], bg + z[18:21],
                ba + z[21:24], f, g)
        return res

    def factor_inputs(cam_pose, vel):
        return cam_pose[pi], cam_pose[pj], vel[pi], vel[pj], imu

    def imu_terms(cam_pose, vel, bg, ba, dg):
        """Residuals r (K, 9) and Jacobians J (K, 9, 24 + NG)."""
        res = residual_fn(bg, ba, dg)
        z0 = torch.zeros(24 + NG, device=dev)

        def one(*inp):
            def with_value(z):
                r = res(z, *inp)
                return r, r
            J, r = torch.func.jacfwd(with_value, has_aux=True)(z0)
            return r, J

        return torch.func.vmap(one)(*factor_inputs(cam_pose, vel))

    def imu_residuals(cam_pose, vel, bg, ba, dg):
        res = residual_fn(bg, ba, dg)
        z0 = torch.zeros(24 + NG, device=dev)
        return torch.func.vmap(lambda *inp: res(z0, *inp))(
            *factor_inputs(cam_pose, vel))

    def imu_cost(r):
        return torch.einsum("ka,kab,kb->", r, infos, r)

    if use_kernels:
        from gslam_tpu_torch.ops.cuda.schur import (
            ba_cost_kernel, schur_reduce_kernel,
        )
        reduce_fn, vcost_fn = schur_reduce_kernel, ba_cost_kernel
    else:
        reduce_fn, vcost_fn = schur_reduce, ba_cost

    def total_cost(cam_pose, point_xyz, vel, bg, ba, dg):
        # the bias prior enters H as pure damping (no gradient or cost
        # term), so the accept objective is exactly the data cost
        vc = vcost_fn(vis._replace(cam_pose=cam_pose, point_xyz=point_xyz),
                      huber_delta)
        return vc + imu_cost(imu_residuals(cam_pose, vel, bg, ba, dg))

    eye_n = 1e-8 * torch.eye(N, device=dev)
    diag = torch.arange(N, device=dev)
    bias_sl = torch.arange(9 * C, 9 * C + 6, device=dev)
    nan = torch.full((), float("nan"), device=dev)
    tail_free = torch.ones(3 * C + 6 + NG, dtype=torch.bool, device=dev)
    pose_rows_free = cam_free[:, None].expand(C, 6).reshape(-1)

    cam_pose, point_xyz = vis.cam_pose, vis.point_xyz
    vel, bg, ba = problem.vel, problem.bias_g, problem.bias_a
    dg = torch.zeros(NG, device=dev)
    lam = torch.full((), lm_lambda0, dtype=torch.float32, device=dev)
    cost = total_cost(cam_pose, point_xyz, vel, bg, ba, dg)
    costs = [cost]
    for it in range(iters):
        poses_free = it >= min(warm_start, iters)
        S, b_s, W, Hpp_inv, bp = reduce_fn(
            vis._replace(cam_pose=cam_pose, point_xyz=point_xyz), lam,
            huber_delta)
        r, J = imu_terms(cam_pose, vel, bg, ba, dg)

        # the full system over [xi | vel | bg ba (| dg)]
        H = torch.zeros((N, N), device=dev)
        b = torch.zeros(N, device=dev)
        H[:6 * C, :6 * C] = S
        b[:6 * C] = b_s
        WJ = torch.einsum("kab,kbd->kad", infos, J)    # (K, 9, 24 + NG)
        Hk = torch.einsum("kda,kdb->kab", J, WJ)       # (K, 24+NG, 24+NG)
        bk = torch.einsum("kda,kd->ka", WJ, r)
        H.index_put_((idx[:, :, None], idx[:, None, :]), Hk,
                     accumulate=True)
        b.index_put_((idx,), bk, accumulate=True)
        # bias random-walk prior as PURE DAMPING (H only)
        H[bias_sl, bias_sl] += bias_prior
        # fixed cameras pin only the pose rows (the gauge); velocities
        # are never gauge dofs.  During warm-start the pose block is
        # frozen entirely
        free = torch.cat([pose_rows_free & poses_free, tail_free])
        H = torch.where(free[:, None] & free[None, :], H, torch.zeros_like(H))
        H[diag, diag] += torch.where(free, lam, torch.ones_like(lam))
        b = b * free

        L, info = torch.linalg.cholesky_ex(H + eye_n)
        dx = -torch.cholesky_solve(b[:, None], L)[:, 0]
        dx = torch.where(info == 0, dx, nan)           # NaN as cho_solve
        dx = dx * free
        dxc = dx[:6 * C].reshape(C, 6) * cam_free[:, None]
        dvel = dx[6 * C:9 * C].reshape(C, 3)
        dbg = dx[9 * C:9 * C + 3]
        dba = dx[9 * C + 3:9 * C + 6]
        dgrav = dx[9 * C + 6:]
        # landmark back-substitution, frozen with the poses in warm-start
        dxp = -torch.einsum("pab,pb->pa", Hpp_inv,
                            bp + schur_wt_dxc(W, dx[:6 * C]))
        dxp = dxp * pt_free[:, None] * poses_free

        new_pose = se3_mul(se3_exp(dxc), cam_pose)
        new_xyz = point_xyz + dxp
        new_vel = vel + dvel
        new_bg = bg + dbg
        new_ba = ba + dba
        new_dg = dg + dgrav
        new_cost = total_cost(new_pose, new_xyz, new_vel, new_bg, new_ba,
                              new_dg)
        accept = ((new_cost < cost) & torch.isfinite(new_cost)
                  & torch.isfinite(new_pose).all()
                  & torch.isfinite(new_xyz).all()
                  & torch.isfinite(new_vel).all())
        cam_pose = torch.where(accept, new_pose, cam_pose)
        point_xyz = torch.where(accept, new_xyz, point_xyz)
        vel = torch.where(accept, new_vel, vel)
        bg = torch.where(accept, new_bg, bg)
        ba = torch.where(accept, new_ba, ba)
        dg = torch.where(accept, new_dg, dg)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e3)
        cost = torch.where(accept, new_cost, cost)
        costs.append(cost)
    out = problem._replace(
        vision=vis._replace(cam_pose=cam_pose, point_xyz=point_xyz),
        vel=vel, bias_g=bg, bias_a=ba, gravity_w=gravity_of(dg))
    return out, torch.stack(costs)


# ---------------------------------------------------------------------------
# visual-inertial initialization (gravity / velocity / scale alignment)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def stack_factors(factors: List[ImuFactor], device=None) -> ImuFactor:
    """List of ImuFactor (tensors or numpy arrays) -> one stacked
    (K, ...) ImuFactor of tensors on ``device`` (numpy factors are
    stacked on the host and copied once per field)."""
    out = []
    for k in ImuFactor._fields:
        leaves = [getattr(f, k) for f in factors]
        if all(torch.is_tensor(x) for x in leaves):
            out.append(torch.stack(leaves).to(device or leaves[0].device))
        else:
            out.append(torch.as_tensor(
                np.stack([_np(x) for x in leaves]).astype(np.float32),
                device=device))
    return ImuFactor(*out)


def estimate_gravity_velocity(poses_cw, pair_i, pair_j, imu: ImuFactor,
                              with_scale: bool = False,
                              fix_magnitude: bool = True
                              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Linear VI alignment: (gravity_w (3,), vel (C, 3), scale).

    Solves the stacked preintegration constraints for per-keyframe
    world velocities, gravity and (mono) metric scale given the vision
    keyframe poses, by least squares on the host in float64.  With
    ``fix_magnitude`` gravity is renormalized to 9.81 and the velocities
    re-solved with gravity fixed."""
    poses = _np(poses_cw).astype(np.float64)
    C = poses.shape[0]
    pi = _np(pair_i)
    pj = _np(pair_j)
    K = pi.shape[0]
    # rotations in float32, as the JAX package forms them
    R_cw = quat_to_matrix(torch.as_tensor(
        poses[:, 3:7], dtype=torch.float32)).numpy().astype(np.float64)
    R_wb = np.swapaxes(R_cw, 1, 2)
    p_wb = -np.einsum("cij,cj->ci", R_wb, poses[:, :3])
    dv = _np(imu.dv).astype(np.float64)
    dp = _np(imu.dp).astype(np.float64)
    dt = _np(imu.dt).astype(np.float64)

    n_x = 3 * C + 3 + (1 if with_scale else 0)
    A = np.zeros((6 * K, n_x))
    rhs = np.zeros(6 * K)
    for k in range(K):
        i, j = int(pi[k]), int(pj[k])
        Ri_T = R_wb[i].T
        T = dt[k]
        # velocity rows: Ri^T (v_j - v_i - g T) = dv
        A[6 * k:6 * k + 3, 3 * j:3 * j + 3] = Ri_T
        A[6 * k:6 * k + 3, 3 * i:3 * i + 3] = -Ri_T
        A[6 * k:6 * k + 3, 3 * C:3 * C + 3] = -Ri_T * T
        rhs[6 * k:6 * k + 3] = dv[k]
        # position rows: Ri^T (s (p_j - p_i) - v_i T - 0.5 g T^2) = dp
        A[6 * k + 3:6 * k + 6, 3 * i:3 * i + 3] = -Ri_T * T
        A[6 * k + 3:6 * k + 6, 3 * C:3 * C + 3] = -0.5 * Ri_T * T * T
        dpw = Ri_T @ (p_wb[j] - p_wb[i])
        if with_scale:
            A[6 * k + 3:6 * k + 6, -1] = dpw
            rhs[6 * k + 3:6 * k + 6] = dp[k]
        else:
            rhs[6 * k + 3:6 * k + 6] = dp[k] - dpw
    x, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    g = x[3 * C:3 * C + 3]
    scale = float(x[-1]) if with_scale else 1.0
    if fix_magnitude and np.linalg.norm(g) > 1e-6:
        g_fixed = g / np.linalg.norm(g) * GRAVITY
        # second pass: substitute g, re-solve velocities (+ scale)
        keep = list(range(3 * C)) + ([n_x - 1] if with_scale else [])
        x2, *_ = np.linalg.lstsq(A[:, keep],
                                 rhs - A[:, 3 * C:3 * C + 3] @ g_fixed,
                                 rcond=None)
        g = g_fixed
        scale = float(x2[-1]) if with_scale else 1.0
        vel = x2[:3 * C].reshape(C, 3)
    else:
        vel = x[:3 * C].reshape(C, 3)
    return g, vel, scale


def gravity_align_rotation(g_w) -> np.ndarray:
    """Quaternion q (4,) [w, x, y, z] rotating the world so that the
    gravity estimate maps to [0, 0, -9.81] (z-up)."""
    g = np.asarray(g_w, np.float64)
    n = np.linalg.norm(g)
    if n < 1e-9:
        return np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    a = g / n
    b = np.asarray([0.0, 0.0, -1.0])
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-9:
        if c > 0:
            return np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
        return np.asarray([0.0, 1.0, 0.0, 0.0], np.float32)  # 180 deg
    s = np.sqrt((1.0 + c) * 2.0)
    q = np.asarray([s * 0.5, v[0] / s, v[1] / s, v[2] / s])
    return (q / np.linalg.norm(q)).astype(np.float32)
