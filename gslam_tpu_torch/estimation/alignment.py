"""3D-3D similarity alignment (Umeyama).

Counterpart of ``umeyama_alignment`` in
``gslam_tpu/estimation/alignment.py``; the trajectory evaluation aligns
estimated onto ground-truth positions with it.  The RANSAC variants
(``find_sim3``, ``find_affine3d``, ``find_plane``) come with loop
closure.
"""

from __future__ import annotations

from typing import Optional

import torch

from gslam_tpu_torch.core.sim3 import sim3_make
from gslam_tpu_torch.core.so3 import matrix_to_quat

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
