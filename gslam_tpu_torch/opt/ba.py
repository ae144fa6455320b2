"""Bundle adjustment: Levenberg-Marquardt on the Schur-reduced system.

Counterpart of ``gslam_tpu/opt/ba.py``.  Observations live in a
per-point padded layout (P points x O slots); residuals and Jacobians
are batched tensor expressions, the per-point 3x3 landmark blocks are
inverted in closed form through their Cholesky factor, the camera blocks
are one-hot matrix products, and the reduced camera system
S = Hcc - W Hpp^-1 W^T is solved by Cholesky.  The LM loop runs ``iters``
steps with accept / reject selected on the card (``torch.where``):
nothing inside reads a value back to the host.

``schur_reduce`` and ``ba_cost`` are the plain versions of the Schur (B5)
and cost (B6) kernels of :mod:`gslam_tpu_torch.ops.cuda.schur`;
``bundle_adjust(use_kernels=True)`` routes through the kernels.  Run in
float32 with TF32 off (``torch.backends.cuda.matmul.allow_tf32``), the
precision the JAX package's gold tests pin with
``default_matmul_precision("highest")``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gslam_tpu_torch.core.se3 import se3_apply, se3_exp, se3_mul
from gslam_tpu_torch.core.sim3 import sim3_from_se3
from gslam_tpu_torch.core.so3 import quat_to_matrix
from gslam_tpu_torch.map.arena import edge_slots, set_rows
from gslam_tpu_torch.opt.robust import huber_weight

MAX_CAMS = 32     # cameras the Schur (B5) and cost (B6) kernels take


class BundleProblem(NamedTuple):
    """BundleGraph analog, SoA + per-point padded observations."""

    cam_pose: torch.Tensor    # (C, 7) SE3 world->cam
    cam_fixed: torch.Tensor   # (C,) bool
    point_xyz: torch.Tensor   # (P, 3)
    point_fixed: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor     # (P, O) int32
    obs_uv: torch.Tensor      # (P, O, 2) normalized image coords
    obs_valid: torch.Tensor   # (P, O) bool
    obs_weight: torch.Tensor  # (P, O) information (1/sigma^2)


class BAStats(NamedTuple):
    cost: torch.Tensor        # per-iteration chi2 (iters+1,)
    accepted: torch.Tensor    # (iters,) bool
    final_lambda: torch.Tensor


class SchurW(NamedTuple):
    """W (camera-point coupling) in per-observation block form: W_e
    (P, O, 6, 3) weighted blocks + obs_cam (P, O) camera indices."""

    W_e: torch.Tensor
    obs_cam: torch.Tensor


def _project_residual_jac(problem: BundleProblem):
    """Residuals r (P,O,2), Jc (P,O,2,6), Jp (P,O,2,3), valid mask
    (left-multiplicative SE3 twist [rho, phi])."""
    poses = problem.cam_pose[problem.obs_cam.long()]    # (P, O, 7)
    pc = se3_apply(poses, problem.point_xyz[:, None])   # (P, O, 3)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    front = z > 1e-6
    iz = 1.0 / torch.where(front, z, torch.ones_like(z))
    r = pc[..., :2] * iz[..., None] - problem.obs_uv
    zero = torch.zeros_like(x)
    iz2 = iz * iz
    Jx = torch.stack([iz, zero, -x * iz2,
                      -x * y * iz2, 1.0 + x * x * iz2, -y * iz], -1)
    Jy = torch.stack([zero, iz, -y * iz2,
                      -(1.0 + y * y * iz2), x * y * iz2, x * iz], -1)
    Jc = torch.stack([Jx, Jy], -2)                      # (P, O, 2, 6)
    R = quat_to_matrix(poses[..., 3:7])                 # (P, O, 3, 3)
    dproj = torch.stack([torch.stack([iz, zero, -x * iz2], -1),
                         torch.stack([zero, iz, -y * iz2], -1)], -2)
    Jp = dproj @ R                                      # (P, O, 2, 3)
    return r, Jc, Jp, problem.obs_valid & front


def _project_residual(problem: BundleProblem):
    """Residuals r (P,O,2) + validity, without Jacobians."""
    poses = problem.cam_pose[problem.obs_cam.long()]
    pc = se3_apply(poses, problem.point_xyz[:, None])
    z = pc[..., 2]
    front = z > 1e-6
    proj = pc[..., :2] / torch.where(front, z, torch.ones_like(z))[..., None]
    return proj - problem.obs_uv, problem.obs_valid & front


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form SPD 3x3 inverse through the Cholesky factor:
    inv(A) = L^-T L^-1 with a closed-form triangular inverse."""
    eps = 1e-20
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l11 = torch.sqrt(a11.clamp_min(eps))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt((a22 - l21 * l21).clamp_min(eps))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt((a33 - l31 * l31 - l32 * l32).clamp_min(eps))
    m11, m22, m33 = 1.0 / l11, 1.0 / l22, 1.0 / l33
    m21 = -l21 * m11 * m22
    m32 = -l32 * m22 * m33
    m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33
    i11 = m11 * m11 + m21 * m21 + m31 * m31
    i21 = m21 * m22 + m31 * m32
    i31 = m31 * m33
    i22 = m22 * m22 + m32 * m32
    i32 = m32 * m33
    i33 = m33 * m33
    return torch.stack([torch.stack([i11, i21, i31], -1),
                        torch.stack([i21, i22, i32], -1),
                        torch.stack([i31, i32, i33], -1)], -2)


def ba_cost(problem: BundleProblem, huber_delta: float = 0.01
            ) -> torch.Tensor:
    """Total robust chi2: the plain version of the B6 cost kernel."""
    r, valid = _project_residual(problem)
    e = torch.linalg.vector_norm(r, dim=-1)
    w = problem.obs_weight * huber_weight(e, huber_delta)
    return torch.where(valid, w * e * e, torch.zeros_like(e)).sum()


def schur_wt_dxc(W: SchurW, dxc_flat: torch.Tensor) -> torch.Tensor:
    """W^T @ dxc for landmark back-substitution: (6C,) -> (P, 3)."""
    g = dxc_flat.reshape(-1, 6)[W.obs_cam.long()]       # (P, O, 6)
    return torch.einsum("poab,poa->pb", W.W_e, g)


def schur_partials(prob: BundleProblem, lam: torch.Tensor,
                   huber_delta: float):
    """The Schur pieces of one (single-device) problem:
    (Hcc (C,6,6) undamped, bc (C,6), S_corr (6C,6C), b_corr (C,6),
    SchurW, Hpp_inv (P,3,3), bp (P,3))."""
    C = prob.cam_pose.shape[0]
    P, O = prob.obs_cam.shape
    cam_free = ~prob.cam_fixed
    pt_free = ~prob.point_fixed
    obs_cam = prob.obs_cam.long()

    r, Jc, Jp, valid = _project_residual_jac(prob)
    e = torch.linalg.vector_norm(r, dim=-1)
    w = prob.obs_weight * huber_weight(e, huber_delta)
    w = torch.where(valid, w, torch.zeros_like(w))     # (P, O)
    Jc = Jc * cam_free[obs_cam][..., None, None]
    Jp = Jp * pt_free[:, None, None, None]

    sw = w[..., None, None]
    Hpp = torch.einsum("poia,poib->pab", Jp * sw, Jp)  # (P, 3, 3)
    bp = torch.einsum("poia,poi->pa", Jp * sw, r)      # (P, 3)
    Hcc_e = torch.einsum("poia,poib->poab", Jc * sw, Jc)
    bc_e = torch.einsum("poia,poi->poa", Jc * sw, r)
    onehot = (obs_cam.reshape(-1)[:, None] == torch.arange(
        C, device=obs_cam.device)[None, :]).to(w.dtype)     # (PO, C)
    Hcc = (onehot.T @ Hcc_e.reshape(-1, 36)).reshape(C, 6, 6)
    bc = onehot.T @ bc_e.reshape(-1, 6)
    W_e = torch.einsum("poia,poib->poab", Jc * sw, Jp)  # (P, O, 6, 3)

    tr = (Hpp[..., 0, 0] + Hpp[..., 1, 1] + Hpp[..., 2, 2]) / 3.0
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp = Hpp + (lam + 1e-5 * tr)[..., None, None] * eye3
    Hpp = torch.where(pt_free[:, None, None], Hpp, eye3[None])
    Hpp_inv = _inv3x3(Hpp)
    bp = bp * pt_free[:, None]
    bc = bc * cam_free[:, None]

    G3 = onehot.reshape(P, O, C)
    Wp = torch.einsum("poc,poab->pcab", G3, W_e)        # (P, C, 6, 3)
    Wf = Wp.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    Y = torch.einsum("cpab,pbd->cpad", Wp.permute(1, 0, 2, 3), Hpp_inv)
    Yf = Y.permute(0, 2, 1, 3).reshape(C * 6, P * 3)
    S_corr = Yf @ Wf.T
    b_corr = (Yf @ bp.reshape(-1)).reshape(C, 6)
    return (Hcc, bc, S_corr, b_corr, SchurW(W_e, prob.obs_cam), Hpp_inv,
            bp)


def assemble_schur(Hcc: torch.Tensor, bvec: torch.Tensor,
                   S_corr: torch.Tensor, lam: torch.Tensor,
                   cam_free: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damp and pin the camera blocks and form S = Hcc - S_corr and
    b_s; ``bvec`` (C, 6) is the already-reduced right-hand side."""
    C = Hcc.shape[0]
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Hcc = Hcc + lam * eye6
    Hcc = torch.where(cam_free[:, None, None], Hcc, eye6[None])
    eyeC = torch.eye(C, dtype=Hcc.dtype, device=Hcc.device)
    Hcc_d = torch.einsum("ij,iab->iajb", eyeC, Hcc).reshape(C * 6, C * 6)
    return Hcc_d - S_corr, bvec.reshape(-1)


def schur_reduce(prob: BundleProblem, lam: torch.Tensor, huber_delta: float):
    """Landmark-eliminated normal equations at the current state:
    (S (6C, 6C), b_s (6C,), SchurW, Hpp_inv (P, 3, 3), bp (P, 3)).  The
    plain version of the B5 Schur kernel."""
    Hcc, bc, S_corr, b_corr, W, Hpp_inv, bp = schur_partials(
        prob, lam, huber_delta)
    cam_free = ~prob.cam_fixed
    S, b_s = assemble_schur(Hcc, bc * cam_free[:, None] - b_corr, S_corr,
                            lam, cam_free)
    return S, b_s, W, Hpp_inv, bp


def resolve_ba_kernels(use_kernels: bool, n_cams: int) -> bool:
    """Whether a BA over ``n_cams`` cameras goes through the B5 / B6
    kernels: when the caller asks for kernels AND ``1 <= n_cams <=
    MAX_CAMS``, the kernels' contract; the plain Schur path otherwise.
    A rule of shape, as ``resolve_ba_backend`` / ``schur_pallas_ok`` are
    in the JAX package: nothing gives way to the plain version because a
    kernel failed to build or launch, and the launch counters show which
    path a run took.  Local BA and :func:`global_bundle_adjust` both
    call it; :func:`bundle_adjust` itself takes ``use_kernels`` as
    given and raises beyond the contract."""
    return bool(use_kernels) and 1 <= n_cams <= MAX_CAMS


def bundle_adjust(problem: BundleProblem, iters: int = 10,
                  lm_lambda0: float = 1e-4, huber_delta: float = 0.01,
                  use_kernels: bool = False
                  ) -> Tuple[BundleProblem, BAStats]:
    """LM bundle adjustment; returns the updated problem and its stats.

    ``use_kernels`` routes the normal equations and the accept-test cost
    through the B5 / B6 kernels (their plain versions on CPU tensors).
    No step reads a value back to the host: a step whose Cholesky factor
    fails gives NaN updates, which the accept test rejects.
    """
    C = problem.cam_pose.shape[0]
    cam_free = ~problem.cam_fixed
    pt_free = ~problem.point_fixed
    dev = problem.cam_pose.device

    if use_kernels:
        from gslam_tpu_torch.ops.cuda.schur import (
            ba_cost_kernel, schur_reduce_kernel,
        )
        reduce_fn, cost_fn = schur_reduce_kernel, ba_cost_kernel
    else:
        reduce_fn, cost_fn = schur_reduce, ba_cost

    def cost_of(cam_pose, point_xyz):
        return cost_fn(problem._replace(cam_pose=cam_pose,
                                        point_xyz=point_xyz), huber_delta)

    eye = 1e-8 * torch.eye(6 * C, device=dev)
    nan = torch.full((), float("nan"), device=dev)
    cam_pose, point_xyz = problem.cam_pose, problem.point_xyz
    lam = torch.full((), lm_lambda0, dtype=torch.float32, device=dev)
    cost = cost_of(cam_pose, point_xyz)
    costs, accs = [cost], []
    for _ in range(iters):
        S, b_s, W, Hpp_inv, bp = reduce_fn(
            problem._replace(cam_pose=cam_pose, point_xyz=point_xyz), lam,
            huber_delta)
        L, info = torch.linalg.cholesky_ex(S + eye)
        dxc = -torch.cholesky_solve(b_s[:, None], L)[:, 0]
        dxc = torch.where(info == 0, dxc, nan)          # NaN as cho_solve
        dxc = dxc.reshape(C, 6) * cam_free[:, None]
        dxp = -torch.einsum("pab,pb->pa", Hpp_inv,
                            bp + schur_wt_dxc(W, dxc.reshape(-1)))
        dxp = dxp * pt_free[:, None]
        new_pose = se3_mul(se3_exp(dxc), cam_pose)
        new_xyz = point_xyz + dxp
        new_cost = cost_of(new_pose, new_xyz)
        accept = ((new_cost < cost) & torch.isfinite(new_cost)
                  & torch.isfinite(new_pose).all()
                  & torch.isfinite(new_xyz).all())
        cam_pose = torch.where(accept, new_pose, cam_pose)
        point_xyz = torch.where(accept, new_xyz, point_xyz)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e3)
        costs.append(cost)
        accs.append(accept)
    out = problem._replace(cam_pose=cam_pose, point_xyz=point_xyz)
    return out, BAStats(cost=torch.stack(costs),
                        accepted=torch.stack(accs) if accs else
                        torch.zeros(0, dtype=torch.bool, device=dev),
                        final_lambda=lam)


# ---------------------------------------------------------------------------
# arena bridging (local-BA window extraction / write-back)


def build_problem_from_arena(arena, cam_ids: torch.Tensor,
                             point_ids: torch.Tensor,
                             fixed_cam_mask: torch.Tensor, camera,
                             max_obs_per_point: int = 16
                             ) -> Tuple[BundleProblem, torch.Tensor]:
    """Extract a BA window from the map arena.

    cam_ids (C,) arena frame slots (-1 pad); point_ids (P,) arena point
    slots (-1 pad).  Each point's first ``max_obs_per_point`` in-window
    observations (edge-list order) fill its slots; keypoint pixels are
    unprojected with ``camera``.  Points with fewer than two in-window
    observations are fixed.  Returns (problem, obs_found_mask)."""
    dev = arena.device
    C = cam_ids.shape[0]
    P = point_ids.shape[0]
    O = max_obs_per_point
    cam_ok = cam_ids >= 0
    pt_ok = point_ids >= 0

    frame2win = set_rows(
        torch.full((arena.cap_frames + 1,), -1, dtype=torch.int32,
                   device=dev),
        torch.where(cam_ok, cam_ids, arena.cap_frames),
        torch.arange(C, dtype=torch.int32, device=dev))
    point2win = set_rows(
        torch.full((arena.cap_points + 1,), -1, dtype=torch.int32,
                   device=dev),
        torch.where(pt_ok, point_ids, arena.cap_points),
        torch.arange(P, dtype=torch.int32, device=dev))
    e_cam = frame2win[arena.obs_frame.long()]
    e_pt = point2win[arena.obs_point.long()]
    e_ok = arena.obs_valid & (e_cam >= 0) & (e_pt >= 0)

    order, ok_sorted, tgt_p, tgt_o = edge_slots(e_pt, e_ok, P, O)

    uv_pix = arena.frame_kp_uv[arena.obs_frame.long(), arena.obs_kp.long()]
    rays_sorted = camera.unproject(uv_pix)[..., :2][order]
    cam_sorted = torch.where(ok_sorted, e_cam[order], 0)

    obs_cam = torch.zeros((P + 1, O), dtype=torch.int32, device=dev)
    obs_cam[tgt_p, tgt_o] = cam_sorted
    obs_uv = torch.zeros((P + 1, O, 2), device=dev)
    obs_uv[tgt_p, tgt_o] = rays_sorted
    obs_valid = torch.zeros((P + 1, O), dtype=torch.bool, device=dev)
    obs_valid[tgt_p, tgt_o] = ok_sorted
    obs_cam, obs_uv, obs_valid = obs_cam[:P], obs_uv[:P], obs_valid[:P]

    problem = BundleProblem(
        cam_pose=arena.frame_pose[cam_ids.clamp_min(0).long()][:, :7],
        cam_fixed=fixed_cam_mask | ~cam_ok,
        point_xyz=arena.point_xyz[point_ids.clamp_min(0).long()],
        point_fixed=~pt_ok | (obs_valid.sum(-1) < 2),
        obs_cam=obs_cam, obs_uv=obs_uv, obs_valid=obs_valid,
        obs_weight=torch.ones((P, O), device=dev))
    return problem, obs_valid.any(-1)


def write_back_to_arena(arena, problem: BundleProblem,
                        cam_ids: torch.Tensor, point_ids: torch.Tensor):
    """Write optimized poses / points back into the arena (masked; the
    last writer of a repeated slot wins, as in the reference)."""
    cam_ok = cam_ids >= 0
    cslot = cam_ids.clamp_min(0)
    fp = set_rows(arena.frame_pose, cslot,
                  torch.where(cam_ok[:, None], sim3_from_se3(problem.cam_pose),
                              arena.frame_pose[cslot.long()]))
    pt_ok = (point_ids >= 0) & ~problem.point_fixed
    pslot = point_ids.clamp_min(0)
    px = set_rows(arena.point_xyz, pslot,
                  torch.where(pt_ok[:, None], problem.point_xyz,
                              arena.point_xyz[pslot.long()]))
    return arena.replace(frame_pose=fp, point_xyz=px)


def frame_obs_slabs(arena, camera, max_obs_per_frame: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame observation slabs: (data (F, K, 5) = [X | ray_xy],
    weight (F, K)) gathered from the arena edge list, each frame keeping
    its first K valid observations in edge-list order.  Shared by
    :func:`motion_only_refine` and the loop closer's pose information."""
    dev = arena.device
    F = arena.cap_frames
    K = max_obs_per_frame or arena.cap_kps
    e_ok = arena.obs_valid & arena.point_valid[arena.obs_point.long()]
    order, ok_s, tgt_f, tgt_k = edge_slots(arena.obs_frame, e_ok, F, K)
    X_e = arena.point_xyz[arena.obs_point[order].long()]
    uv_pix = arena.frame_kp_uv[arena.obs_frame.long(),
                               arena.obs_kp.long()][order]
    data_e = torch.cat([X_e, camera.unproject(uv_pix)[..., :2]], -1)
    data = torch.zeros((F + 1, K, 5), device=dev)
    data[tgt_f, tgt_k] = data_e
    wgt = torch.zeros((F + 1, K), device=dev)
    wgt[tgt_f, tgt_k] = ok_s.to(torch.float32)
    return data[:F], wgt[:F]


def motion_only_refine(arena, camera, iters: int = 5,
                       max_obs_per_frame: Optional[int] = None):
    """Refine EVERY keyframe pose against the current (fixed) landmarks:
    with the landmarks fixed each camera is independent, so this is one
    batched motion-only Gauss-Newton over all frames.  Keyframe 0, frames
    with fewer than 6 observations and non-finite results keep their
    pose."""
    from gslam_tpu_torch.estimation.pnp import refine_pose_gn

    F = arena.cap_frames
    data, wgt = frame_obs_slabs(arena, camera, max_obs_per_frame)
    poses0 = arena.frame_pose[:, :7]
    new_poses = refine_pose_gn(poses0, data, wgt, iters=iters)
    keep = (~arena.frame_valid) | (wgt.sum(-1) < 6) \
        | (torch.arange(F, device=arena.device) == 0) \
        | ~torch.isfinite(new_poses).all(-1)
    fp = arena.frame_pose.clone()
    fp[:, :7] = torch.where(keep[:, None], poses0, new_poses)
    return arena.replace(frame_pose=fp)


def global_bundle_adjust(arena, camera, iters: int = 10,
                         max_cams: Optional[int] = None,
                         max_points: Optional[int] = 4096,
                         max_obs_per_point: int = 16, mesh=None,
                         sweeps: int = 2, n_gauge: int = 1,
                         use_kernels: bool = True):
    """Global BA over the whole arena (after a loop closure).

    Covers every valid keyframe and landmark.  ``max_cams`` defaults to
    all keyframes; ``max_points`` bounds the per-solve landmark count
    (the dense-W Schur layout is (6C, 3P)), and when the map exceeds it
    the pass is chunked: successive structure-only solves over point
    chunks ordered by observation count (cameras held fixed), then a
    motion-only pass over all cameras, repeated ``sweeps`` times.  The
    ``n_gauge`` oldest keyframes are held fixed.  The B5 / B6 kernels
    run when :func:`resolve_ba_kernels` allows (at most ``MAX_CAMS``
    keyframes), the plain Schur path above that.  Returns (arena, the
    concatenated per-solve cost histories).  Reads the keyframe count,
    the landmark count and the per-landmark observation counts back to
    the host, once per call."""
    if mesh is not None:
        raise NotImplementedError(
            "global BA over a device mesh is not ported to gslam_tpu_torch "
            "yet (ROADMAP Queue A item 15)")
    dev = arena.device
    n_f = int(arena.n_frames)
    n_p = int(arena.point_valid.sum())
    if n_f < 2 or n_p == 0:
        return arena, torch.zeros(1, device=dev)

    C = n_f if max_cams is None else min(max_cams, n_f)
    cam_start = n_f - C
    cam_ids = torch.arange(cam_start, cam_start + C, dtype=torch.int32,
                           device=dev)
    fixed = torch.arange(C, device=dev) < n_gauge
    kernels = resolve_ba_kernels(use_kernels, C)

    # landmarks ordered best-constrained first (observation count);
    # integer adds, so the order of the card's atomics cannot matter
    obs_count = torch.zeros(arena.cap_points, dtype=torch.int64,
                            device=dev).index_add(
        0, arena.obs_point.long(), arena.obs_valid.to(torch.int64))
    obs_count = torch.where(arena.point_valid, obs_count, -1).cpu().numpy()
    pt_order = np.argsort(-obs_count, kind="stable")[:n_p]

    budget = n_p if max_points is None else min(max_points, n_p)
    n_chunks = -(-n_p // budget)
    if n_chunks == 1:
        sweeps = 1

    costs_all = []
    for _ in range(sweeps):
        for ci in range(n_chunks):
            chunk = pt_order[ci * budget:(ci + 1) * budget]
            point_ids = np.full(budget, -1, np.int32)
            point_ids[:len(chunk)] = chunk
            point_ids = torch.from_numpy(point_ids).to(dev)
            problem, _ = build_problem_from_arena(
                arena, cam_ids, point_ids, fixed, camera,
                max_obs_per_point=max_obs_per_point)
            if n_chunks > 1:
                # resection-intersection: per chunk each camera sees a
                # fraction of its observations, so structure passes move
                # points only and a motion-only pass over all
                # observations refines every camera (below)
                problem = problem._replace(
                    cam_fixed=torch.ones_like(problem.cam_fixed))
            problem, stats = bundle_adjust(problem, iters=iters,
                                           use_kernels=kernels)
            arena = write_back_to_arena(arena, problem, cam_ids, point_ids)
            costs_all.append(stats.cost)
        if n_chunks > 1:
            arena = motion_only_refine(arena, camera, iters=iters)
    return arena, torch.cat(costs_all)
