"""Two-view epipolar geometry: F / E estimation, decomposition,
triangulation.

Counterpart of ``gslam_tpu/estimation/epipolar.py``.  Fits are DLT and
batched SVD: :func:`~gslam_tpu_torch.estimation.ransac.run_ransac` hands
the minimal solvers (B, k, 4) samples, and every function here takes
leading batch dimensions where the JAX package ``vmap``s.  Inputs are
normalized image coordinates (rays with z = 1) unless noted.  The SVDs
are ``torch.linalg.svd`` on 3x3, 4x4 and k x 9 matrices (LAPACK on the
CPU, cuSOLVER on the card), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from gslam_tpu_torch.core.se3 import se3_make
from gslam_tpu_torch.core.so3 import (
    matrix_to_quat, quat_rotate, quat_to_matrix,
)
from gslam_tpu_torch.estimation.ransac import run_ransac

_EPS = 1e-12


def _normalize_points(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization of (..., k, 2) points: zero mean, sqrt(2)
    mean distance; returns (xn, T (..., 3, 3))."""
    mean = x.mean(-2, keepdim=True)
    d = torch.sqrt(((x - mean) ** 2).sum(-1)).mean(-1)
    s = torch.full_like(d, math.sqrt(2.0)) / d.clamp_min(1e-8)
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack([s, z, -s * mean[..., 0, 0],
                     z, s, -s * mean[..., 0, 1],
                     z, z, o], -1).reshape(*s.shape, 3, 3)
    return (x - mean) * s[..., None, None], T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the least singular value of A
    (..., m, n), full matrices (m may be less than n)."""
    return torch.linalg.svd(A, full_matrices=True)[2][..., -1, :]


def _eight_point(pts: torch.Tensor) -> torch.Tensor:
    """(..., k >= 8, 4) [x1, y1, x2, y2] -> (..., 3, 3) F / E by DLT (no
    rank forcing)."""
    x1, y1, x2, y2 = pts.unbind(-1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)               # (..., k, 9)
    return _null_vector(A).reshape(*pts.shape[:-2], 3, 3)


def _force_rank2(F: torch.Tensor) -> torch.Tensor:
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return (u * s[..., None, :]) @ vt


def _force_essential(E: torch.Tensor) -> torch.Tensor:
    u, _, vt = torch.linalg.svd(E)
    d = torch.diag(E.new_ones(3)).clone()
    d[2, 2] = 0.0
    return u @ d @ vt


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def sampson_distance(F: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """First-order geometric error of x2' F x1 = 0: F (..., 3, 3)
    against pts (N, 4) -> (..., N)."""
    x1 = _homogeneous(pts[:, 0:2])
    x2 = _homogeneous(pts[:, 2:4])
    Fx1 = x1 @ F.transpose(-1, -2)          # (..., N, 3) = F @ x1
    Ftx2 = x2 @ F                           # (..., N, 3) = F^T @ x2
    num = torch.sum(x2 * Fx1, -1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return num / den.clamp_min(_EPS)


def find_fundamental(pts1: torch.Tensor, pts2: torch.Tensor,
                     valid: torch.Tensor, threshold: float = 3e-6,
                     B: int = 512,
                     generator: Optional[torch.Generator] = None,
                     uniforms: Optional[torch.Tensor] = None):
    """RANSAC fundamental matrix from pixel (or normalized) pairs (N, 2);
    ``threshold`` on the squared Sampson distance.  Draws from
    ``generator`` or ``uniforms`` (B, 8).  Returns (F, inliers,
    n_inliers)."""
    data = torch.cat([pts1, pts2], -1)

    def fit(sample):
        n1, T1 = _normalize_points(sample[..., :2])
        n2, T2 = _normalize_points(sample[..., 2:])
        Fn = _force_rank2(_eight_point(torch.cat([n1, n2], -1)))
        return T2.transpose(-1, -2) @ Fn @ T1

    return run_ransac(fit, sampson_distance, data, valid, min_set=8,
                      threshold=threshold, B=B, generator=generator,
                      uniforms=uniforms)


def find_essential(rays1: torch.Tensor, rays2: torch.Tensor,
                   valid: torch.Tensor, threshold: float = 1e-6,
                   B: int = 512,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None):
    """RANSAC essential matrix from normalized coordinates (N, 2) each.
    Draws from ``generator`` or ``uniforms`` (B, 8).  Returns (E,
    inliers, n_inliers); decompose with :func:`decompose_essential`."""
    data = torch.cat([rays1, rays2], -1)

    def fit(sample):
        return _force_essential(_eight_point(sample))

    return run_ransac(fit, sampson_distance, data, valid, min_set=8,
                      threshold=threshold, B=B, generator=generator,
                      uniforms=uniforms)


def _skew(t: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices [t]x."""
    x, y, z = t.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       -1).reshape(*t.shape[:-1], 3, 3)


def essential_from_rt(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]x R for the pose taking camera-1 coordinates to camera 2
    (x2 ~ R x1 + t)."""
    return _skew(t) @ quat_to_matrix(q)


def _projection(T: torch.Tensor) -> torch.Tensor:
    """SE3 (7,) -> the 3x4 matrix [R | t]."""
    return torch.cat([quat_to_matrix(T[3:7]), T[:3, None]], -1)


def triangulate(T1: torch.Tensor, T2: torch.Tensor, rays1: torch.Tensor,
                rays2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-view DLT triangulation, batched over N.

    T1 / T2: (7,) world->camera poses; rays (N, 2) normalized
    coordinates.  Returns (points_world (N, 3), depths in camera 1
    (N,)).
    """
    P1 = _projection(T1)
    P2 = _projection(T2)
    A = torch.stack([
        rays1[:, 0:1] * P1[2] - P1[0],
        rays1[:, 1:2] * P1[2] - P1[1],
        rays2[:, 0:1] * P2[2] - P2[0],
        rays2[:, 1:2] * P2[2] - P2[1]], -2)                # (N, 4, 4)
    X = torch.linalg.svd(A)[2][..., -1, :]
    w = X[:, 3:4]
    X = X[:, :3] / torch.where(w.abs() < _EPS, w.new_full((), _EPS), w)
    depth1 = (quat_rotate(T1[3:7], X) + T1[:3])[..., 2]
    return X, depth1


def _identity_pose(like: torch.Tensor) -> torch.Tensor:
    z = like.new_zeros(3)
    return torch.cat([z, like.new_ones(1), z])


def cheirality_vote(R: torch.Tensor, t: torch.Tensor, rays1: torch.Tensor,
                    rays2: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate motions R (C, 3, 3), t (C, 3) -> (the pose T_21 (7,)
    that puts the most valid correspondences in front of both cameras,
    its count); the first candidate on ties."""
    I7 = _identity_pose(rays1)
    poses, scores = [], []
    for c in range(R.shape[0]):
        T21 = se3_make(t[c], matrix_to_quat(R[c]))
        X, d1 = triangulate(I7, T21, rays1, rays2)
        d2 = (quat_rotate(T21[3:7], X) + T21[:3])[..., 2]
        scores.append(torch.sum((d1 > 0) & (d2 > 0) & valid))
        poses.append(T21)
    scores = torch.stack(scores)
    best = torch.argmax(scores).reshape(1)
    return torch.stack(poses).index_select(0, best)[0], scores[best][0]


def decompose_essential(E: torch.Tensor, rays1: torch.Tensor,
                        rays2: torch.Tensor, valid: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E -> relative pose T_21 (7,) by cheirality voting over the four
    candidates of the SVD decomposition; |t| = 1 (monocular scale).
    Returns (T_21, its count)."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    W = torch.zeros_like(E)
    W[0, 1] = -1.0
    W[1, 0] = 1.0
    W[2, 2] = 1.0
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    t = t / torch.linalg.vector_norm(t).clamp_min(_EPS)
    return cheirality_vote(torch.stack([R1, R1, R2, R2]),
                           torch.stack([t, -t, t, -t]), rays1, rays2, valid)
