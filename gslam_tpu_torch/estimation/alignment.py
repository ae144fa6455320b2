"""3D-3D alignment: Umeyama, and RANSAC similarity, affine and plane fits.

Counterpart of ``gslam_tpu/estimation/alignment.py`` (the reference
Estimator's findSIM3, findAffine3D and findPlane).  The trajectory
evaluation aligns estimated onto ground-truth positions with
``umeyama_alignment``.  The RANSAC fits draw from a ``torch.Generator``,
or take the reference's draws as ``uniforms`` (see
:func:`gslam_tpu_torch.estimation.ransac.run_ransac`); a minimal set's
fit is batched over the B hypotheses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gslam_tpu_torch.core.sim3 import sim3_apply, sim3_make
from gslam_tpu_torch.core.so3 import matrix_to_quat
from gslam_tpu_torch.estimation.ransac import run_ransac

_EPS = 1e-12


def umeyama_alignment(src: torch.Tensor, dst: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      with_scale: bool = True) -> torch.Tensor:
    """Closed-form similarity aligning src (N, 3) -> dst (N, 3): Sim3
    (8,), weighted, with the SVD sign correction; ``with_scale=False``
    returns s = 1.  Runs on the tensors' device."""
    w = torch.ones(src.shape[0], dtype=src.dtype, device=src.device) \
        if weights is None else weights
    wn = (w / w.sum().clamp_min(_EPS))[:, None]
    mu_s = (wn * src).sum(0)
    mu_d = (wn * dst).sum(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * wn).T @ sc                      # (3, 3) dst x src
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.ones(3, dtype=src.dtype, device=src.device)
    D = torch.cat([D[:2], d[None]])
    R = U @ torch.diag(D) @ Vt
    if with_scale:
        var_s = (wn[:, 0] * (sc ** 2).sum(-1)).sum()
        s = (S * D).sum() / var_s.clamp_min(_EPS)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * (R @ mu_s)
    return sim3_make(t, matrix_to_quat(R), s[None])


def _sim3_residual(S: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., N) of src mapped by S (..., 8) to dst."""
    src, dst = data[:, :3], data[:, 3:6]
    return torch.sum((sim3_apply(S[..., None, :], src) - dst) ** 2, -1)


def find_sim3(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
              threshold: float = 0.01, B: int = 256, with_scale: bool = True,
              generator: Optional[torch.Generator] = None,
              uniforms: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC similarity src (N, 3) -> dst (N, 3) from 3-point Umeyama
    fits, refit on the inliers (weighted Umeyama): (Sim3 (8,), inliers
    (N,), count).  Draws: ``generator`` or ``uniforms`` (B, 3)."""
    data = torch.cat([src, dst], -1)
    fit = torch.vmap(lambda s: umeyama_alignment(s[:, :3], s[:, 3:6],
                                                 with_scale=with_scale))
    _, inl, _ = run_ransac(fit, _sim3_residual, data, valid, min_set=3,
                           threshold=threshold, B=B, generator=generator,
                           uniforms=uniforms)
    S = umeyama_alignment(src, dst, weights=inl.to(src.dtype),
                          with_scale=with_scale)
    inl = (_sim3_residual(S, data) < threshold) & valid
    return S, inl, inl.sum()


def _affine_fit(samples: torch.Tensor) -> torch.Tensor:
    """(B, k >= 4, 6) -> (B, 3, 4) affine maps by least squares."""
    src, dst = samples[..., :3], samples[..., 3:6]
    A = torch.cat([src, torch.ones_like(src[..., :1])], -1)   # (B, k, 4)
    return torch.linalg.lstsq(A, dst).solution.transpose(-1, -2)


def _affine_residual(M: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    src, dst = data[:, :3], data[:, 3:6]
    pred = src @ M[..., :3].transpose(-1, -2) + M[..., None, :, 3]
    return torch.sum((pred - dst) ** 2, -1)


def find_affine3d(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                  threshold: float = 0.01, B: int = 256,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[torch.Tensor] = None):
    """RANSAC 3D affine transform (3, 4) from 4-point least-squares fits:
    (M, inliers, count).  Draws: ``generator`` or ``uniforms`` (B, 4)."""
    data = torch.cat([src, dst], -1)
    return run_ransac(_affine_fit, _affine_residual, data, valid, min_set=4,
                      threshold=threshold, B=B, generator=generator,
                      uniforms=uniforms)


def _plane_fit(samples: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) point triples -> (B, 4) planes [n (unit), d], n.x + d = 0."""
    p0, p1, p2 = samples[:, 0], samples[:, 1], samples[:, 2]
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(_EPS)
    return torch.cat([n, -(n * p0).sum(-1, keepdim=True)], -1)


def _plane_residual(plane: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return torch.abs((data @ plane[..., :3, None])[..., 0] + plane[..., 3:4])


def find_plane(points: torch.Tensor, valid: torch.Tensor,
               threshold: float = 0.01, B: int = 128,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[torch.Tensor] = None):
    """RANSAC dominant plane [nx, ny, nz, d] of points (N, 3): (plane,
    inliers, count).  Draws: ``generator`` or ``uniforms`` (B, 3)."""
    return run_ransac(_plane_fit, _plane_residual, points, valid, min_set=3,
                      threshold=threshold, B=B, generator=generator,
                      uniforms=uniforms)
