"""Camera projection models: pinhole, ATAN, OpenCV and OCAM.

Counterpart of ``gslam_tpu/core/camera.py``: batched pure functions per
model plus the host-side ``Camera`` descriptor.  Projection maps
camera-frame points (..., 3) to pixels (..., 2) and a validity mask;
unprojection maps pixels to rays (..., 3) with z = 1 (unit-norm for
OCAM).  The model is fixed per camera, so dispatch is a Python lookup.

The functions repeat the reference's float32 operations in its order
(the OpenCV undistortion's fixed 8 iterations, OCAM's Horner sum over
the padded coefficient vector), and read nothing back to the host, so
that they run inside a captured CUDA graph.

Parameter packing (the first four are fx, fy, cx, cy except for OCAM):

* pinhole: [fx, fy, cx, cy]
* atan:    [fx, fy, cx, cy, w]           (w: the FOV distortion)
* opencv:  [fx, fy, cx, cy, k1, k2, p1, p2, k3]
* ocam:    [cx, cy, c, d, e, poly(OCAM_POLY_N), inv_poly(OCAM_INVPOLY_N)]
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

_EPS = 1e-9


def _where_valid(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z > eps, 1 / z where valid else 1)."""
    valid = z > _EPS
    return valid, 1.0 / torch.where(valid, z, torch.ones_like(z))


# ---------------------------------------------------------------------------
# pinhole


def pinhole_project(params: torch.Tensor, p: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) -> (pixels (..., 2), valid (...,))."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    valid, iz = _where_valid(p[..., 2])
    u = fx * p[..., 0] * iz + cx
    v = fy * p[..., 1] * iz + cy
    return torch.stack([u, v], dim=-1), valid


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-depth rays (..., 3)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


# ---------------------------------------------------------------------------
# ATAN (the PTAM FOV model): r_d = atan(2 r tan(w / 2)) / w
# w = 0 is the pinhole: a where on the device picks factor 1 (the other
# branch's 0 / 0 is discarded), as the reference's traced where does.


def atan_project(params: torch.Tensor, p: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    fx, fy, cx, cy, w = (params[0], params[1], params[2], params[3],
                         params[4])
    valid, iz = _where_valid(p[..., 2])
    x, y = p[..., 0] * iz, p[..., 1] * iz
    r = torch.sqrt((x * x + y * y).clamp_min(_EPS * _EPS))
    tan_half = torch.tan(w / 2.0)
    use_dist = torch.abs(w) > 1e-6
    factor = torch.where(use_dist, torch.atan(2.0 * r * tan_half) / (w * r),
                         torch.ones_like(r))
    u = fx * factor * x + cx
    v = fy * factor * y + cy
    return torch.stack([u, v], dim=-1), valid


def atan_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy, w = (params[0], params[1], params[2], params[3],
                         params[4])
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    rd = torch.sqrt((xd * xd + yd * yd).clamp_min(_EPS * _EPS))
    tan_half = torch.tan(w / 2.0)
    use_dist = torch.abs(w) > 1e-6
    factor = torch.where(use_dist, torch.tan(rd * w) / (2.0 * rd * tan_half),
                         torch.ones_like(rd))
    return torch.stack([factor * xd, factor * yd, torch.ones_like(xd)],
                       dim=-1)


# ---------------------------------------------------------------------------
# OpenCV radial-tangential (k1 k2 p1 p2 k3)


def _opencv_distort(k: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    k1, k2, p1, p2, k3 = k[0], k[1], k[2], k[3], k[4]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def opencv_project(params: torch.Tensor, p: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    valid, iz = _where_valid(p[..., 2])
    xd, yd = _opencv_distort(params[4:9], p[..., 0] * iz, p[..., 1] * iz)
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1), valid


def opencv_unproject(params: torch.Tensor, uv: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Fixed-point undistortion: always ``iters`` steps, no convergence
    test (a test would read the device inside a captured graph)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:9]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        xe, ye = _opencv_distort(k, x, y)
        x = x - (xe - xd)
        y = y - (ye - yd)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


# ---------------------------------------------------------------------------
# OCAM (Scaramuzza omnidirectional)

OCAM_POLY_N = 8      # cam2world polynomial degree bound (padded)
OCAM_INVPOLY_N = 16  # world2cam inverse polynomial degree bound (padded)


def ocam_pack(center: Sequence[float], affine_cde: Sequence[float],
              poly: Sequence[float], inv_poly: Sequence[float]) -> np.ndarray:
    """OCAM calibration -> the fixed-length float32 parameter vector
    [cx, cy, c, d, e, poly(OCAM_POLY_N), inv_poly(OCAM_INVPOLY_N)]."""
    p = np.zeros(5 + OCAM_POLY_N + OCAM_INVPOLY_N, np.float32)
    p[0:2] = center
    p[2:5] = affine_cde
    p[5:5 + len(poly)] = poly
    p[5 + OCAM_POLY_N:5 + OCAM_POLY_N + len(inv_poly)] = inv_poly
    return p


def _polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[i] x^i by Horner from the highest (padded) entry
    down: in float32 at rho ~ 300 the order is the result."""
    acc = torch.zeros_like(x)
    for i in range(coeffs.shape[0] - 1, -1, -1):
        acc = acc * x + coeffs[i]
    return acc


def ocam_project(params: torch.Tensor, p: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    cx, cy = params[0], params[1]
    c, d, e = params[2], params[3], params[4]
    inv_poly = params[5 + OCAM_POLY_N:]
    norm = torch.sqrt((p[..., 0] ** 2 + p[..., 1] ** 2).clamp_min(
        _EPS * _EPS))
    # angle from the optical axis as atan2(z, norm), Scaramuzza's
    theta = torch.atan2(p[..., 2], norm)
    rho = _polyval(inv_poly, theta)
    xn = p[..., 0] / norm * rho
    yn = p[..., 1] / norm * rho
    u = xn * c + yn * d + cx
    v = xn * e + yn + cy
    valid = torch.isfinite(u) & torch.isfinite(v)
    return torch.stack([u, v], dim=-1), valid


def ocam_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> unit-norm rays (the OCAM convention; z may be < 0)."""
    cx, cy = params[0], params[1]
    c, d, e = params[2], params[3], params[4]
    poly = params[5:5 + OCAM_POLY_N]
    # invert the affine [[c, d], [e, 1]]
    det = (c - d * e).clamp_min(_EPS)
    up = uv[..., 0] - cx
    vp = uv[..., 1] - cy
    xn = (up - d * vp) / det
    yn = (-e * up + c * vp) / det
    rho = torch.sqrt((xn * xn + yn * yn).clamp_min(_EPS * _EPS))
    z = _polyval(poly, rho)
    ray = torch.stack([xn, yn, z], dim=-1)
    return ray / torch.linalg.vector_norm(ray, dim=-1,
                                          keepdim=True).clamp_min(_EPS)


# ---------------------------------------------------------------------------
# host-side descriptor

_PROJECT = {
    "pinhole": pinhole_project,
    "atan": atan_project,
    "opencv": opencv_project,
    "ocam": ocam_project,
}
_UNPROJECT = {
    "pinhole": pinhole_unproject,
    "atan": atan_unproject,
    "opencv": opencv_unproject,
    "ocam": ocam_unproject,
}


@dataclasses.dataclass(frozen=True, eq=False)
class Camera:
    """Host-side camera descriptor: model name, image size and float32
    parameters.  ``project`` / ``unproject`` run on the device of their
    argument; the parameter vector is copied to each device once
    (:meth:`params_on`), before any graph capture reads it."""

    model: str
    width: int
    height: int
    params: np.ndarray
    _on: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        if self.model not in _PROJECT:
            raise ValueError(f"unknown camera model {self.model!r}; "
                             f"have {sorted(_PROJECT)}")
        object.__setattr__(self, "params",
                           np.asarray(self.params, np.float32))

    @staticmethod
    def pinhole(width: int, height: int, fx: float, fy: float,
                cx: float, cy: float) -> "Camera":
        return Camera("pinhole", width, height, [fx, fy, cx, cy])

    @staticmethod
    def atan(width: int, height: int, fx: float, fy: float, cx: float,
             cy: float, w: float) -> "Camera":
        return Camera("atan", width, height, [fx, fy, cx, cy, w])

    @staticmethod
    def opencv(width: int, height: int, fx: float, fy: float, cx: float,
               cy: float, k1: float = 0, k2: float = 0, p1: float = 0,
               p2: float = 0, k3: float = 0) -> "Camera":
        return Camera("opencv", width, height,
                      [fx, fy, cx, cy, k1, k2, p1, p2, k3])

    @staticmethod
    def ocam(width: int, height: int, center, affine_cde, poly,
             inv_poly) -> "Camera":
        return Camera("ocam", width, height,
                      ocam_pack(center, affine_cde, poly, inv_poly))

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
        uv, valid = _PROJECT[self.model](self.params_on(p.device), p)
        inside = ((uv[..., 0] >= 0) & (uv[..., 0] < self.width)
                  & (uv[..., 1] >= 0) & (uv[..., 1] < self.height))
        return uv, valid & inside

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> rays (..., 3) (z = 1; unit-norm for OCAM)."""
        return _UNPROJECT[self.model](self.params_on(uv.device), uv)

    def is_valid(self) -> bool:
        return self.width > 0 and self.height > 0 and len(self.params) >= 4

    # for OCAM these read [cx, cy, c, d]: fx is cx, as in the reference
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

    def K(self) -> np.ndarray:
        """3x3 intrinsic matrix (the pinhole part)."""
        return np.array([[self.fx, 0, self.cx],
                         [0, self.fy, self.cy],
                         [0, 0, 1]], np.float32)

    def info(self) -> str:
        return (f"{self.model} {self.width}x{self.height} "
                f"params={self.params.tolist()}")
