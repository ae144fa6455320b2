"""Two-view initialization with H / E model selection.

Counterpart of ``gslam_tpu/estimation/init2view.py``: an essential
matrix (8-point RANSAC with local-optimization refits) and a homography
(4-point RANSAC) are fitted to the same correspondences, each is scored
by a truncated chi-square sum, and the winner's decomposition is the
relative pose.  Planar and low-parallax scenes break the 8-point
solve, and homographies break on general 3D scenes, so monocular
bootstraps need both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gslam_tpu_torch.estimation.epipolar import (
    _eight_point, _force_essential, decompose_essential, essential_from_rt,
    find_essential, sampson_distance,
)
from gslam_tpu_torch.estimation.homography import (
    decompose_homography, find_homography, homography_transfer_error,
)


class TwoViewResult(NamedTuple):
    T_21: torch.Tensor       # (7,) relative SE3, |t| = 1
    inliers: torch.Tensor    # (N,) bool, the winning model's inlier mask
    n_inliers: torch.Tensor  # () int32
    used_h: torch.Tensor     # () bool: the homography model won
    n_e: torch.Tensor        # () int32 essential-inlier count
    n_h: torch.Tensor        # () int32 homography-inlier count


def two_view_draws(B: int = 256, generator: Optional[torch.Generator] = None,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The uniforms of one :func:`two_view_geometry` call, (B, 8) for
    the essential RANSAC then (B, 4) for the homography's, from
    ``generator``."""
    return (torch.rand((B, 8), generator=generator, device=device),
            torch.rand((B, 4), generator=generator, device=device))


def two_view_geometry(rays1: torch.Tensor, rays2: torch.Tensor,
                      valid: torch.Tensor, sigma: float = 3e-3,
                      h_ratio: float = 0.45, B: int = 256,
                      lo_rounds: int = 2,
                      generator: Optional[torch.Generator] = None,
                      uniforms: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                      ) -> TwoViewResult:
    """Relative pose from normalized correspondences, planar-safe.

    Each model accumulates ``max(0, Gamma - d^2)`` per correspondence
    and direction (symmetric transfer for H, Sampson for E), Gamma =
    5.99 sigma^2, with the E inlier cutoff at 3.84 sigma^2; H wins when
    S_H / (S_H + S_E) > ``h_ratio`` (the ORB-SLAM initializer's rule).
    ``sigma`` is the keypoint noise in normalized units (pixels over the
    focal length).  The RANSAC draws are ``uniforms`` = ((B, 8), (B, 4))
    for E and H, as the JAX package splits its key in two, or
    :func:`two_view_draws` from ``generator``.
    """
    if uniforms is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or explicit uniforms")
        uniforms = two_view_draws(B, generator, rays1.device)
    u_e, u_h = uniforms
    data = torch.cat([rays1, rays2], -1)
    sigma2 = sigma * sigma
    e_threshold = 3.84 * sigma2
    gamma = 5.99 * sigma2

    E, inl_e, _ = find_essential(rays1, rays2, valid, threshold=e_threshold,
                                 B=B, uniforms=u_e)
    for _ in range(lo_rounds):
        d = sampson_distance(E, data)
        d = torch.where(valid, d, d.new_full((), float("inf")))
        order = torch.argsort(d, stable=True)[:64]
        E2 = _force_essential(_eight_point(data[order]))
        inl2 = (sampson_distance(E2, data) < e_threshold) & valid
        better = inl2.sum() > inl_e.sum()
        E = torch.where(better, E2, E)
        inl_e = torch.where(better, inl2, inl_e)
    n_e = inl_e.sum()

    H, _, _ = find_homography(rays1, rays2, valid, threshold=gamma, B=B,
                              uniforms=u_h)

    # truncated chi-square scores, both directions for each model
    zero = data.new_zeros(())
    d_e = sampson_distance(E, data)
    s_e = 2.0 * torch.sum(torch.where(valid & (d_e < e_threshold),
                                      gamma - d_e, zero))
    d_h1 = homography_transfer_error(H, data)
    data_rev = torch.cat([rays2, rays1], -1)
    d_h2 = homography_transfer_error(torch.linalg.inv_ex(H)[0], data_rev)
    s_h = (torch.sum(torch.where(valid & (d_h1 < gamma), gamma - d_h1, zero))
           + torch.sum(torch.where(valid & (d_h2 < gamma), gamma - d_h2,
                                   zero)))
    inl_h = valid & (d_h1 < gamma) & (d_h2 < gamma)
    n_h = inl_h.sum()

    T_e, _ = decompose_essential(E, rays1, rays2, inl_e)
    T_h, _ = decompose_homography(H, rays1, rays2, inl_h)

    # an H-selected pair still reports the epipolar inliers of the
    # H-derived motion (off-plane points are valid correspondences for BA
    # though no single homography maps them)
    t_h = T_h[:3] / torch.linalg.vector_norm(T_h[:3]).clamp_min(1e-12)
    d_he = sampson_distance(essential_from_rt(T_h[3:7], t_h), data)
    inl_he = valid & (d_he < gamma)

    use_h = s_h > h_ratio * (s_h + s_e)
    T = torch.where(use_h, T_h, T_e)
    inl = torch.where(use_h, inl_he, inl_e)
    return TwoViewResult(T_21=T, inliers=inl,
                         n_inliers=inl.sum().to(torch.int32), used_h=use_h,
                         n_e=n_e.to(torch.int32), n_h=n_h.to(torch.int32))
