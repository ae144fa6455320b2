"""Stereo matching: per-keypoint disparity and depth from a rectified
pair.

Counterpart of ``gslam_tpu/ops/stereo.py``, plain PyTorch as the
reference is plain jnp: one dense (Kl, Kr) Hamming matrix masked by the
rectified epipolar gate (the same row within ``v_tol``, disparity in
(0.1, ``max_disparity``]), the first minimum per left keypoint, then
depth = fx * baseline / disparity.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gslam_tpu_torch.ops.matching import INF_DIST, hamming_matrix


def match_stereo(desc_l: torch.Tensor, valid_l: torch.Tensor,
                 uv_l: torch.Tensor, desc_r: torch.Tensor,
                 valid_r: torch.Tensor, uv_r: torch.Tensor,
                 max_disparity: float = 128.0, v_tol: float = 2.0,
                 max_dist: float = 64.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left -> right match under the rectified-stereo gate.

    Returns (disparity (Kl,), valid (Kl,)): disparity = u_l - u_r > 0,
    0 where no right keypoint within ``max_dist`` bits passes the gate.
    """
    D = hamming_matrix(desc_l, desc_r)
    du = uv_l[:, None, 0] - uv_r[None, :, 0]     # disparity candidates
    dv = (uv_l[:, None, 1] - uv_r[None, :, 1]).abs()
    gate = ((du > 0.1) & (du <= max_disparity) & (dv <= v_tol)
            & valid_l[:, None] & valid_r[None, :])
    D = torch.where(gate, D, D.new_full((), INF_DIST))
    best, j = torch.min(D, dim=1)                # first minimum on ties
    ok = valid_l & (best <= max_dist)
    disp = torch.gather(du, 1, j[:, None])[:, 0]
    return torch.where(ok, disp, disp.new_zeros(())), ok


def stereo_depth(disparity: torch.Tensor, valid: torch.Tensor, fx: float,
                 baseline: float) -> torch.Tensor:
    """depth = fx * baseline / disparity; inf where invalid.  The
    numerator is one float32 tensor, so the quotient rounds as the
    reference's (a Python number over a tensor would be multiplied by
    the reciprocal)."""
    d = torch.where(valid & (disparity > 1e-3), disparity,
                    disparity.new_full((), float("inf")))
    num = torch.full((), fx * baseline, dtype=d.dtype, device=d.device)
    return num / d
