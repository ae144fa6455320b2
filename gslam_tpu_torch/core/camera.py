"""Pinhole projection, params = [fx, fy, cx, cy].

Counterpart of the pinhole part of ``gslam_tpu/core/camera.py``; the
ATAN, OpenCV and OCAM models are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-9


def pinhole_project(params: torch.Tensor, p: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) -> (pixels (..., 2), valid (...,))."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = p[..., 2]
    valid = z > _EPS
    iz = 1.0 / torch.where(valid, z, torch.ones_like(z))
    u = fx * p[..., 0] * iz + cx
    v = fy * p[..., 1] * iz + cy
    return torch.stack([u, v], dim=-1), valid


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-depth rays (..., 3)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)
