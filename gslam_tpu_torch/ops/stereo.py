"""Stereo matching: per-keypoint disparity and depth from a rectified
pair.

Counterpart of ``gslam_tpu/ops/stereo.py``, plain PyTorch as the
reference is plain jnp: one dense (Kl, Kr) Hamming matrix masked by the
rectified epipolar gate (the same row within ``v_tol``, disparity in
(0.1, ``max_disparity``]), the first minimum per left keypoint, then
depth = fx * baseline / disparity.

Given each keypoint's pyramid level, the gate is ORB-SLAM2's
(``Frame::ComputeStereoMatches``): a right keypoint is a candidate only
within one octave of the left one, and the row band widens with the left
keypoint's level to ``v_tol * scale^level``.  The JAX package extracts
the right image at one level and has no such gate.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gslam_tpu_torch.ops.matching import INF_DIST, hamming_matrix


MAX_LEVELS = 32
_ROW_TOLS: Dict[tuple, torch.Tensor] = {}


def row_tolerances(v_tol: float, scale: float, device) -> torch.Tensor:
    """(MAX_LEVELS,) float32: ``v_tol * scale^level`` for each level, each
    product taken in Python's float64 and rounded once; copied to
    ``device`` once (a copy per call would wait for the card)."""
    key = (torch.device(device), float(v_tol), float(scale))
    tols = _ROW_TOLS.get(key)
    if tols is None:
        tols = _ROW_TOLS[key] = torch.tensor(
            [v_tol * scale ** i for i in range(MAX_LEVELS)],
            dtype=torch.float32, device=device)
    return tols


def match_stereo(desc_l: torch.Tensor, valid_l: torch.Tensor,
                 uv_l: torch.Tensor, desc_r: torch.Tensor,
                 valid_r: torch.Tensor, uv_r: torch.Tensor,
                 max_disparity: float = 128.0, v_tol: float = 2.0,
                 max_dist: float = 64.0,
                 levels_l: Optional[torch.Tensor] = None,
                 levels_r: Optional[torch.Tensor] = None,
                 scale: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left -> right match under the rectified-stereo gate.

    Returns (disparity (Kl,), valid (Kl,)): disparity = u_l - u_r > 0,
    0 where no right keypoint within ``max_dist`` bits passes the gate.
    With ``levels_l`` (Kl,) and ``levels_r`` (Kr,), each keypoint's
    pyramid level, the gate is octave-gated: levels at most one apart,
    rows within ``v_tol * scale^level_l`` (the product rounded once to
    float32 per level)."""
    D = hamming_matrix(desc_l, desc_r)
    du = uv_l[:, None, 0] - uv_r[None, :, 0]     # disparity candidates
    dv = (uv_l[:, None, 1] - uv_r[None, :, 1]).abs()
    if levels_l is None:
        row = dv <= v_tol
    else:
        tol = row_tolerances(v_tol, scale, dv.device)[levels_l]
        row = (dv <= tol[:, None]) \
            & ((levels_l[:, None] - levels_r[None, :]).abs() <= 1)
    gate = ((du > 0.1) & (du <= max_disparity) & row
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
