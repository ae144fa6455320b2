"""Pinhole projection, params = [fx, fy, cx, cy].

Counterpart of the pinhole part of ``gslam_tpu/core/camera.py``: the
functions ``pinhole_project`` / ``pinhole_unproject`` and the host-side
``Camera`` descriptor.  The ATAN, OpenCV and OCAM models are not ported
yet; ``Camera`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
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


@dataclasses.dataclass(frozen=True, eq=False)
class Camera:
    """Host-side camera descriptor (model name + float32 parameters).

    ``project`` / ``unproject`` run on the device of their argument; the
    parameter vector is copied to each device once.  Only the pinhole
    model is ported (ROADMAP Queue A item 2 holds the others).
    """

    model: str
    width: int
    height: int
    params: np.ndarray
    _on: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        if self.model != "pinhole":
            raise NotImplementedError(
                f"camera model {self.model!r} is not ported yet (ROADMAP "
                "Queue A item 2: ATAN, OpenCV and OCAM lens models)")
        object.__setattr__(self, "params",
                           np.asarray(self.params, np.float32))

    @staticmethod
    def pinhole(width: int, height: int, fx: float, fy: float,
                cx: float, cy: float) -> "Camera":
        return Camera("pinhole", width, height, [fx, fy, cx, cy])

    @staticmethod
    def from_fov(width: int, height: int, fov_deg: float) -> "Camera":
        """Pinhole from the horizontal field of view."""
        f = width / (2.0 * np.tan(np.radians(fov_deg) / 2.0))
        return Camera.pinhole(width, height, f, f, width / 2.0, height / 2.0)

    def params_on(self, device) -> torch.Tensor:
        dev = torch.device(device)
        t = self._on.get(dev)
        if t is None:
            t = self._on[dev] = torch.as_tensor(self.params, device=dev)
        return t

    def project(self, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Camera-frame points (..., 3) -> pixels (..., 2), in-image mask."""
        uv, valid = pinhole_project(self.params_on(p.device), p)
        inside = ((uv[..., 0] >= 0) & (uv[..., 0] < self.width)
                  & (uv[..., 1] >= 0) & (uv[..., 1] < self.height))
        return uv, valid & inside

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> rays (..., 3) with z = 1."""
        return pinhole_unproject(self.params_on(uv.device), uv)

    @property
    def fx(self) -> float:
        return float(self.params[0])

    @property
    def fy(self) -> float:
        return float(self.params[1])

    @property
    def cx(self) -> float:
        return float(self.params[2])

    @property
    def cy(self) -> float:
        return float(self.params[3])
