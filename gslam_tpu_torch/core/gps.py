"""Geodesy: WGS84 LLA <-> ECEF <-> local ENU.

Counterpart of ``gslam_tpu/core/gps.py``.  Angles are degrees at the
interface (as GPS files give them), metres elsewhere.

Precision: ECEF magnitudes are about 6.4e6 m, where float32 resolves
about 0.5 m.  So every conversion through ECEF runs on the host in
numpy float64, and what goes to a device is local ENU (small, exact in
float32): :func:`enu_tensor` rebases on the host and moves the result.
"""

from __future__ import annotations

import numpy as np
import torch

from gslam_tpu_torch.utils.platform import require_device

WGS84_A = 6378137.0            # semi-major axis (m)
WGS84_F = 1.0 / 298.257223563  # flattening
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared


def lla_to_ecef(lla) -> np.ndarray:
    """(..., 3) [lat_deg, lon_deg, alt_m] -> ECEF (..., 3) metres."""
    lla = np.asarray(lla, np.float64)
    lat = np.radians(lla[..., 0])
    lon = np.radians(lla[..., 1])
    alt = lla[..., 2]
    slat, clat = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * slat * slat)
    x = (n + alt) * clat * np.cos(lon)
    y = (n + alt) * clat * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + alt) * slat
    return np.stack([x, y, z], axis=-1)


def ecef_to_lla(ecef, iters: int = 5) -> np.ndarray:
    """ECEF (..., 3) -> [lat_deg, lon_deg, alt_m] (Bowring iteration)."""
    ecef = np.asarray(ecef, np.float64)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    lon = np.arctan2(y, x)
    p = np.sqrt(np.clip(x * x + y * y, 1e-12, None))
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(iters):
        slat = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * slat * slat)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + alt)))
    slat = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * slat * slat)
    alt = p / np.cos(lat) - n
    return np.stack([np.degrees(lat), np.degrees(lon), alt], axis=-1)


def _enu_rotation(lat_deg, lon_deg) -> np.ndarray:
    """ECEF -> ENU rotation (..., 3, 3) at the given origin."""
    lat = np.radians(lat_deg)
    lon = np.radians(lon_deg)
    sl, cl = np.sin(lon), np.cos(lon)
    sp, cp = np.sin(lat), np.cos(lat)
    rows = np.stack([
        -sl, cl, np.zeros_like(sl),
        -sp * cl, -sp * sl, cp,
        cp * cl, cp * sl, sp,
    ], axis=-1)
    return rows.reshape(*rows.shape[:-1], 3, 3)


def ecef_to_enu(ecef, origin_lla) -> np.ndarray:
    """ECEF points (..., 3) -> ENU metres about origin [lat, lon, alt]."""
    origin_lla = np.asarray(origin_lla, np.float64)
    o_ecef = lla_to_ecef(origin_lla)
    R = _enu_rotation(origin_lla[..., 0], origin_lla[..., 1])
    d = np.asarray(ecef, np.float64) - o_ecef
    return (R @ d[..., None])[..., 0]


def enu_to_ecef(enu, origin_lla) -> np.ndarray:
    origin_lla = np.asarray(origin_lla, np.float64)
    o_ecef = lla_to_ecef(origin_lla)
    R = _enu_rotation(origin_lla[..., 0], origin_lla[..., 1])
    return o_ecef + (np.swapaxes(R, -1, -2)
                     @ np.asarray(enu, np.float64)[..., None])[..., 0]


def lla_to_enu(lla, origin_lla) -> np.ndarray:
    """[lat, lon, alt] -> local ENU metres (the GPS-edge measurement)."""
    return ecef_to_enu(lla_to_ecef(lla), origin_lla)


def enu_to_lla(enu, origin_lla) -> np.ndarray:
    return ecef_to_lla(enu_to_ecef(enu, origin_lla))


def lla_to_enu_np(lla, origin_lla) -> np.ndarray:
    """Float64 LLA -> ENU on the host (the reference's name for it)."""
    return lla_to_enu(lla, origin_lla)


def enu_tensor(lla, origin_lla, device) -> torch.Tensor:
    """LLA fixes -> float32 local ENU on ``device``, rebased on the host
    in float64."""
    return torch.as_tensor(lla_to_enu(lla, origin_lla).astype(np.float32),
                           device=require_device(device))
