"""Homography estimation and decomposition.

Counterpart of ``gslam_tpu/estimation/homography.py``: a 4-point DLT
inside batched RANSAC, and the Faugeras-Lustman decomposition of a
calibrated homography scored by cheirality, which planar two-view
initialization needs where the 8-point essential solve degenerates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gslam_tpu_torch.estimation.epipolar import (
    _homogeneous, _normalize_points, _null_vector, cheirality_vote,
)
from gslam_tpu_torch.estimation.ransac import run_ransac

_EPS = 1e-12


def _dlt_homography(pts: torch.Tensor) -> torch.Tensor:
    """(..., k >= 4, 4) [x1, y1, x2, y2] -> (..., 3, 3) H by DLT, scaled
    so that H[2, 2] = 1."""
    x1, y1, x2, y2 = pts.unbind(-1)
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    r2 = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], -1)
    A = torch.cat([r1, r2], -2)                              # (..., 2k, 9)
    H = _null_vector(A).reshape(*pts.shape[:-2], 3, 3)
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() < _EPS, h22.new_full((), _EPS), h22)


def homography_transfer_error(H: torch.Tensor, pts: torch.Tensor
                              ) -> torch.Tensor:
    """Squared forward transfer error |H x1 - x2|^2: H (..., 3, 3)
    against pts (N, 4) -> (..., N)."""
    y = _homogeneous(pts[:, 0:2]) @ H.transpose(-1, -2)
    w = y[..., 2:3]
    proj = y[..., :2] / torch.where(w.abs() < _EPS, w.new_full((), _EPS), w)
    return torch.sum((proj - pts[:, 2:4]) ** 2, -1)


def find_homography(pts1: torch.Tensor, pts2: torch.Tensor,
                    valid: torch.Tensor, threshold: float = 9.0,
                    B: int = 256,
                    generator: Optional[torch.Generator] = None,
                    uniforms: Optional[torch.Tensor] = None):
    """RANSAC homography; ``threshold`` in squared coordinate units.
    Draws from ``generator`` or ``uniforms`` (B, 4).  Returns (H,
    inliers, n_inliers)."""
    data = torch.cat([pts1, pts2], -1)

    def fit(sample):
        n1, T1 = _normalize_points(sample[..., :2])
        n2, T2 = _normalize_points(sample[..., 2:])
        Hn = _dlt_homography(torch.cat([n1, n2], -1))
        return torch.linalg.inv_ex(T2)[0] @ Hn @ T1

    return run_ransac(fit, homography_transfer_error, data, valid,
                      min_set=4, threshold=threshold, B=B,
                      generator=generator, uniforms=uniforms)


def decompose_homography(H: torch.Tensor, rays1: torch.Tensor,
                         rays2: torch.Tensor, valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Calibrated H (x2 ~ H x1, normalized coordinates) -> relative pose
    T_21 (7,) by cheirality voting over the 8 Faugeras-Lustman solutions
    (per sign choice of x1 and x3 and per +/- d2 branch of
    ``s (R + t n^T / d)``); |t| = 1.  Returns (T_21, its count).  A
    pure rotation decomposes to t ~ 0: gate on parallax before trusting
    the direction."""
    u, d, vt = torch.linalg.svd(H)
    s = torch.linalg.det(u) * torch.linalg.det(vt)
    d1, d2, d3 = d[0], d[1], d[2]
    den = (d1 * d1 - d3 * d3).clamp_min(_EPS)
    x1m = torch.sqrt((d1 * d1 - d2 * d2).clamp_min(0.0) / den)
    x3m = torch.sqrt((d2 * d2 - d3 * d3).clamp_min(0.0) / den)
    d2s = d2.clamp_min(_EPS)
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)
    Rs, ts = [], []
    for positive in (True, False):
        for e1 in (1.0, -1.0):
            for e3 in (1.0, -1.0):
                x1 = e1 * x1m
                x3 = e3 * x3m
                if positive:          # d' = +d2
                    st = (d1 - d3) * x1 * x3 / d2s
                    ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
                    Rp = torch.stack([ct, zero, -st, zero, one, zero,
                                      st, zero, ct]).reshape(3, 3)
                    tp = (d1 - d3) * torch.stack([x1, 0.0 * x1, -x3])
                else:                 # d' = -d2
                    sp = (d1 + d3) * x1 * x3 / d2s
                    cp = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
                    Rp = torch.stack([cp, zero, sp, zero, -one, zero,
                                      sp, zero, -cp]).reshape(3, 3)
                    tp = (d1 + d3) * torch.stack([x1, 0.0 * x1, x3])
                Rs.append(s * (u @ Rp @ vt))
                t = u @ tp
                ts.append(t / torch.linalg.vector_norm(t).clamp_min(_EPS))
    return cheirality_vote(torch.stack(Rs), torch.stack(ts), rays1, rays2,
                           valid)
