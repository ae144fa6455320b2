"""Perspective-n-Point: camera pose from 2D-3D correspondences.

Counterpart of the RANSAC path of ``gslam_tpu/estimation/pnp.py``:
hypotheses from a batched closed-form P3P (Grunert's quartic, Ferrari's
method in float32 with Newton polish), each minimal sample giving up to
four poses disambiguated by a fourth point; refinement on the inliers
is Gauss-Newton on the SE(3) tangent.  The JAX package ``vmap``s over
samples and roots; here those are batch dimensions written out.  The
6-point DLT (``_dlt_pnp``) is there for volumetric scenes, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gslam_tpu_torch.core.se3 import se3_apply, se3_exp, se3_make, se3_mul
from gslam_tpu_torch.core.so3 import matrix_to_quat
from gslam_tpu_torch.estimation.ransac import run_ransac

_EPS = 1e-12


def _dlt_pnp(sample: torch.Tensor) -> torch.Tensor:
    """(..., k >= 6, 5) rows [X, Y, Z, u, v] (u, v normalized) -> T
    (..., 7): DLT for P = [R|t] up to scale, the nearest rotation by SVD,
    the scale from its singular values, and the sign of t that puts most
    sampled points in front.  For volumetric scenes only (coplanar
    samples degenerate); no caller on the tracking path."""
    X = sample[..., :3]
    u = sample[..., 3:4]
    v = sample[..., 4:5]
    Xh = torch.cat([X, torch.ones_like(u)], -1)              # (..., k, 4)
    z = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, z, -u * Xh], -1),
                   torch.cat([z, Xh, -v * Xh], -1)], -2)     # (..., 2k, 12)
    P = torch.linalg.svd(A, full_matrices=True)[2][..., -1, :].reshape(
        *sample.shape[:-2], 3, 4)
    U, s, Vt = torch.linalg.svd(P[..., :3])
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                      d], -1))
    Rn = U @ D @ Vt
    scale = d * 3.0 / s.sum(-1).clamp_min(_EPS)
    t = P[..., 3] * scale[..., None]
    front = (X @ Rn.transpose(-1, -2) + t[..., None, :])[..., 2]
    flip = torch.sign(torch.sum(torch.sign(front), -1))
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    return se3_make(t * flip[..., None], matrix_to_quat(Rn))


def _solve_quartic(c4, c3, c2, c1, c0, newton_iters: int = 4
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real roots of a quartic (elementwise over the coefficients'
    shape S), Ferrari's method.  Returns (roots (*S, 4), valid (*S, 4));
    invalid slots hold garbage that downstream scoring masks."""
    eps = 1e-12
    c4s = torch.where(c4.abs() < eps, c4.new_full((), eps), c4)
    a = c3 / c4s
    b = c2 / c4s
    c = c1 / c4s
    d = c0 / c4s
    # depressed quartic y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a ** 3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0

    # resolvent cubic z^3 + 2p z^2 + (p^2 - 4r) z - q^2 = 0; need z >= 0
    A2 = 2.0 * p
    A1 = p * p - 4.0 * r
    A0 = -q * q
    # depressed cubic w^3 + P w + Q, z = w - A2/3
    P = A1 - A2 * A2 / 3.0
    Q = A0 - A1 * A2 / 3.0 + 2.0 * A2 ** 3 / 27.0
    D = (Q / 2.0) ** 2 + (P / 3.0) ** 3

    def cbrt(x):
        return torch.sign(x) * x.abs() ** (1.0 / 3.0)

    sqrtD = torch.sqrt(D.abs())
    w_pos = cbrt(-Q / 2.0 + sqrtD) + cbrt(-Q / 2.0 - sqrtD)
    # trig branch (three real roots): take the largest
    Psafe = torch.where(P < -eps, P, P.new_full((), -eps))
    arg = torch.clamp(3.0 * Q / (2.0 * Psafe) * torch.sqrt(-3.0 / Psafe),
                      -1.0, 1.0)
    w_tri = 2.0 * torch.sqrt(-Psafe / 3.0) * torch.cos(torch.arccos(arg)
                                                        / 3.0)
    w = torch.where(D >= 0, w_pos, w_tri)
    z = torch.clamp_min(w - A2 / 3.0, 0.0)

    alpha = torch.sqrt(z)
    tiny_alpha = alpha < 1e-6
    alpha_s = torch.where(tiny_alpha, alpha.new_ones(()), alpha)
    beta = (p + z - q / alpha_s) / 2.0
    gamma = (p + z + q / alpha_s) / 2.0
    # biquadratic fallback when alpha ~ 0: y^2 = (-p +/- sqrt(p^2-4r))/2
    disc_bi = p * p - 4.0 * r
    y2a = (-p + torch.sqrt(disc_bi.abs())) / 2.0
    y2b = (-p - torch.sqrt(disc_bi.abs())) / 2.0

    def quad_roots(B_, C_):          # x^2 + B_ x + C_
        disc = B_ * B_ - 4.0 * C_
        s = torch.sqrt(disc.abs())
        return (-B_ + s) / 2.0, (-B_ - s) / 2.0, disc >= 0

    r1, r2, ok12 = quad_roots(alpha, beta)
    r3, r4, ok34 = quad_roots(-alpha, gamma)
    b1 = torch.sqrt(torch.clamp_min(y2a, 0.0))
    b3 = torch.sqrt(torch.clamp_min(y2b, 0.0))
    okb12 = (disc_bi >= 0) & (y2a >= 0)
    okb34 = (disc_bi >= 0) & (y2b >= 0)

    ta = tiny_alpha[..., None]
    y = torch.where(ta, torch.stack([b1, -b1, b3, -b3], -1),
                    torch.stack([r1, r2, r3, r4], -1))
    ok = torch.where(ta, torch.stack([okb12, okb12, okb34, okb34], -1),
                     torch.stack([ok12, ok12, ok34, ok34], -1))
    x = y - (a / 4.0)[..., None]

    c4, c3, c2, c1, c0 = (v[..., None] for v in (c4, c3, c2, c1, c0))
    for _ in range(newton_iters):
        f = (((c4 * x + c3) * x + c2) * x + c1) * x + c0
        fp = ((4.0 * c4 * x + 3.0 * c3) * x + 2.0 * c2) * x + c1
        x = x - f / torch.where(fp.abs() < eps, fp.new_full((), eps), fp)
    return x, ok


def _align_triad(Pw: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    """Rigid transform world->cam from 3 exact point pairs (..., 3, 3):
    matching orthonormal frames of the two triangles, R = B_c B_w^T,
    t = c_c - R c_w."""
    eps = 1e-12

    def frame(P):
        u = P[..., 1, :] - P[..., 0, :]
        v = P[..., 2, :] - P[..., 0, :]
        e1 = u / torch.linalg.vector_norm(u, dim=-1,
                                          keepdim=True).clamp_min(eps)
        n = torch.linalg.cross(u, v, dim=-1)
        e3 = n / torch.linalg.vector_norm(n, dim=-1,
                                          keepdim=True).clamp_min(eps)
        e2 = torch.linalg.cross(e3, e1, dim=-1)
        return torch.stack([e1, e2, e3], dim=-1)   # columns

    R = frame(Pc) @ frame(Pw).transpose(-1, -2)
    t = Pc[..., 0, :] - (R @ Pw[..., 0, :, None])[..., 0]
    return se3_make(t, matrix_to_quat(R))


def _p3p_grunert(sample: torch.Tensor) -> torch.Tensor:
    """(..., 4, 5) rows [X, Y, Z, u, v] -> SE3 (..., 7) world->cam.

    Grunert's P3P on rows 0-2, up to 4 solutions; row 3 disambiguates by
    reprojection.  A sample with no good solution gives the identity.
    """
    eps = 1e-9
    Xw = sample[..., :3, :3]                                # (..., 3, 3)
    bear = torch.cat([sample[..., 3:5],
                      sample.new_ones((*sample.shape[:-1], 1))], -1)
    bear = bear / torch.linalg.vector_norm(bear, dim=-1, keepdim=True)
    j1, j2, j3 = bear[..., 0, :], bear[..., 1, :], bear[..., 2, :]
    P1, P2, P3 = Xw[..., 0, :], Xw[..., 1, :], Xw[..., 2, :]
    a2 = torch.sum((P2 - P3) ** 2, -1)
    b2 = torch.clamp_min(torch.sum((P1 - P3) ** 2, -1), eps)
    c2 = torch.sum((P1 - P2) ** 2, -1)
    A = a2 / b2
    B = c2 / b2
    ca = torch.sum(j2 * j3, -1)
    cb = torch.sum(j1 * j3, -1)
    cg = torch.sum(j1 * j2, -1)

    # quartic in v = s3/s1 (the reference's resultant coefficients)
    c4 = (A ** 2 - 2 * A * B - 2 * A + B ** 2 - 4 * B * ca ** 2
          + 2 * B + 1)
    c3 = (-4 * A ** 2 * cb + 8 * A * B * cb + 4 * A * ca * cg
          + 4 * A * cb - 4 * B ** 2 * cb + 8 * B * ca ** 2 * cb
          + 4 * B * ca * cg - 4 * B * cb - 4 * ca * cg)
    c2_ = (4 * A ** 2 * cb ** 2 + 2 * A ** 2 - 8 * A * B * cb ** 2
           - 4 * A * B - 8 * A * ca * cb * cg - 4 * A * cg ** 2
           + 4 * B ** 2 * cb ** 2 + 2 * B ** 2 - 4 * B * ca ** 2
           - 8 * B * ca * cb * cg + 4 * ca ** 2 + 4 * cg ** 2 - 2)
    c1 = (-4 * A ** 2 * cb + 8 * A * B * cb + 4 * A * ca * cg
          + 8 * A * cb * cg ** 2 - 4 * A * cb - 4 * B ** 2 * cb
          + 4 * B * ca * cg + 4 * B * cb - 4 * ca * cg)
    c0 = A ** 2 - 2 * A * B - 4 * A * cg ** 2 + 2 * A + B ** 2 - 2 * B + 1

    v, v_ok = _solve_quartic(c4, c3, c2_, c1, c0)          # (..., 4)

    # per root: u from eq2, u^2 - 2 u cg + (1 - B(1 + v^2 - 2 v cb)) = 0
    B_, A_, ca_, cb_, cg_, b2_ = (t[..., None]
                                  for t in (B, A, ca, cb, cg, b2))
    k = 1.0 - B_ * (1.0 + v * v - 2.0 * v * cb_)
    disc = torch.clamp_min(cg_ * cg_ - k, 0.0)
    u_cands = torch.stack([cg_ + torch.sqrt(disc), cg_ - torch.sqrt(disc)],
                          -1)                               # (..., 4, 2)
    vv = v[..., None]
    eq1 = (u_cands ** 2 + vv ** 2 - 2 * u_cands * vv * ca_[..., None]
           - A_[..., None] * (1.0 + vv * vv - 2.0 * vv * cb_[..., None]))
    u = torch.take_along_dim(u_cands, torch.argmin(eq1.abs(), -1,
                                                   keepdim=True), -1)[..., 0]
    denom = torch.clamp_min(1.0 + v * v - 2.0 * v * cb_, eps)
    s1 = torch.sqrt(b2_ / denom)
    s2 = u * s1
    s3 = v * s1
    Yc = torch.stack([s1[..., None] * j1[..., None, :],
                      s2[..., None] * j2[..., None, :],
                      s3[..., None] * j3[..., None, :]], -2)  # (..., 4, 3, 3)
    poses = _align_triad(Xw[..., None, :, :].expand_as(Yc), Yc)  # (..., 4, 7)
    good = ((s1 > 0) & (s2 > 0) & (s3 > 0) & v_ok
            & torch.isfinite(poses).all(-1))
    errs = pnp_reproj_error(poses, sample[..., None, 3:4, :])[..., 0]
    errs = torch.where(good, errs, errs.new_full((), float("inf")))
    best = torch.argmin(errs, -1, keepdim=True)             # first minimum
    pose = torch.take_along_dim(poses, best[..., None], -2)[..., 0, :]
    err_best = torch.take_along_dim(errs, best, -1)
    z = pose.new_zeros(3)
    ident = torch.cat([z, pose.new_ones(1), z])   # made on the device
    return torch.where(torch.isfinite(err_best), pose, ident)


def pnp_reproj_error(T: torch.Tensor, data: torch.Tensor,
                     max_depth: float = float("inf")) -> torch.Tensor:
    """Squared reprojection error in normalized image coordinates.

    T (..., 7) broadcast against data (..., N, 5) = [X | ray_xy] ->
    (..., N); points behind the camera or beyond ``max_depth`` get inf.
    """
    pc = se3_apply(T[..., None, :], data[..., :3])
    z = pc[..., 2]
    zs = torch.where(z > _EPS, z, z.new_full((), _EPS))
    proj = pc[..., :2] / zs[..., None]
    err = torch.sum((proj - data[..., 3:5]) ** 2, -1)
    ok = (z > _EPS) & (z < max_depth)
    return torch.where(ok, err, err.new_full((), float("inf")))


def _reproj_jacobian(T: torch.Tensor, data: torch.Tensor,
                     weights: torch.Tensor):
    """Residuals r (..., N, 2), analytic Jacobians J (..., N, 2, 6) of
    the normalized reprojection wrt a left-multiplied twist [rho, phi],
    and the weighted Jacobians J * w, for poses T (..., 7) against data
    (..., N, 5) = [X | ray_xy]; points behind the camera weigh 0."""
    pc = se3_apply(T[..., None, :], data[..., :3])      # (..., N, 3)
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp_min(pc[..., 2], _EPS)
    iz = 1.0 / z
    r = pc[..., :2] * iz[..., None] - data[..., 3:5]
    zero = torch.zeros_like(x)
    Jx = torch.stack([iz, zero, -x * iz * iz,
                      -x * y * iz * iz, 1.0 + x * x * iz * iz, -y * iz],
                     -1)
    Jy = torch.stack([zero, iz, -y * iz * iz,
                      -(1.0 + y * y * iz * iz), x * y * iz * iz, x * iz],
                     -1)
    J = torch.stack([Jx, Jy], -2)                       # (..., N, 2, 6)
    w = (weights * (pc[..., 2] > _EPS))[..., None, None]
    return r, J, J * w


def refine_pose_gn(T: torch.Tensor, data: torch.Tensor,
                   weights: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Gauss-Newton motion-only refinement on the SE(3) tangent.

    Minimizes sum_i w_i |pi(T X_i) - uv_i|^2 over a left-multiplied
    twist with analytic 2x6 Jacobians; 6x6 normal equations per step.
    Batched over leading dimensions: T (..., 7), data (..., N, 5),
    weights (..., N).  A singular system gives a non-finite pose (no
    exception, no host read).
    """
    eye = 1e-6 * torch.eye(6, dtype=data.dtype, device=data.device)
    for _ in range(iters):
        r, J, Jw = _reproj_jacobian(T, data, weights)
        H = torch.einsum("...nia,...nib->...ab", Jw, J) + eye
        b = torch.einsum("...nia,...ni->...a", Jw, r)
        dx = -torch.linalg.solve_ex(H, b[..., None])[0][..., 0]
        T = se3_mul(se3_exp(dx), T)
    return T


def pose_information(T: torch.Tensor, data: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Gauss-Newton pose information H = sum_i w_i J_i^T J_i (..., 6, 6)
    at the solution, from the Jacobians of :func:`refine_pose_gn`, in
    normalized image-coordinate units: the estimator-derived weight of a
    pose-graph edge.  Batched like :func:`refine_pose_gn`."""
    _, J, Jw = _reproj_jacobian(T, data, weights)
    return torch.einsum("...nia,...nib->...ab", Jw, J)


def find_pnp_ransac(points3d: torch.Tensor, rays: torch.Tensor,
                    valid: torch.Tensor, threshold: float = 1e-5,
                    B: int = 256, refine_iters: int = 5,
                    max_depth: float = float("inf"),
                    generator: Optional[torch.Generator] = None,
                    uniforms: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC PnP: world points (N,3) + normalized coords (N,2) -> T_cw.

    threshold: squared normalized-coords reprojection error.  Samples
    come from ``generator``, or from ``uniforms`` (B, 4) when given.
    Returns (T (7,), inlier_mask, n_inliers), GN-refined on inliers.
    """
    data = torch.cat([points3d, rays], -1)

    def err_fn(T, d):
        return pnp_reproj_error(T, d, max_depth=max_depth)

    T, inl, _ = run_ransac(_p3p_grunert, err_fn, data, valid, min_set=4,
                           threshold=threshold, B=B, generator=generator,
                           uniforms=uniforms)
    T = refine_pose_gn(T, data, inl.to(data.dtype), iters=refine_iters)
    err = err_fn(T, data)
    inl = torch.isfinite(err) & (err < threshold) & valid
    return T, inl, inl.sum()
