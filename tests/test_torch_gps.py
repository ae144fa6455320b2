"""The port's geodesy (gslam_tpu_torch.core.gps) against the JAX
package's (gslam_tpu/core/gps.py, called with ``xp=numpy``), all in
float64 on the host.

Tolerances: ECEF, ENU and LLA equal to the JAX package's to 1e-9
(the same numpy float64 arithmetic); round trips LLA -> ECEF -> LLA to
1e-9 degrees and 1e-6 m, LLA -> ENU -> LLA likewise; the float32 ENU
tensor equal to the float64 ENU cast once.
"""

import numpy as np
import pytest
import torch

from gslam_tpu.core import gps as jg
from gslam_tpu_torch.core import gps as tg


def fixes(seed=0, n=200):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-89, 89, n), rng.uniform(-180, 180, n),
                     rng.uniform(-100, 9000, n)], -1)


def track(seed=1, n=100):
    """A drone-survey track: a few hundred metres about an origin."""
    rng = np.random.default_rng(seed)
    origin = np.array([34.0522, -118.2437, 120.0])
    lla = origin + np.cumsum(rng.normal(0, [2e-5, 2e-5, 0.5], (n, 3)), 0)
    return lla, origin


def test_ecef_and_lla_against_reference():
    lla = fixes()
    e_t = tg.lla_to_ecef(lla)
    np.testing.assert_allclose(e_t, jg.lla_to_ecef(lla, xp=np), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tg.ecef_to_lla(e_t),
                               jg.ecef_to_lla(e_t, xp=np), rtol=0, atol=1e-9)
    back = tg.ecef_to_lla(e_t)
    np.testing.assert_allclose(back[:, :2], lla[:, :2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(back[:, 2], lla[:, 2], rtol=0, atol=1e-6)


def test_enu_against_reference_and_round_trip():
    lla, origin = track()
    enu = tg.lla_to_enu(lla, origin)
    np.testing.assert_allclose(enu, jg.lla_to_enu(lla, origin, xp=np),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tg.lla_to_enu_np(lla, origin),
                               jg.lla_to_enu_np(lla, origin), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tg.enu_to_lla(enu, origin),
                               jg.enu_to_lla(enu, origin, xp=np), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tg.enu_to_ecef(enu, origin),
                               jg.enu_to_ecef(enu, origin, xp=np), rtol=0,
                               atol=1e-6)
    back = tg.enu_to_lla(enu, origin)
    np.testing.assert_allclose(back[:, :2], lla[:, :2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(back[:, 2], lla[:, 2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.lla_to_enu(origin, origin), 0, atol=1e-9)
    # a metre north of the origin is a metre of ENU north
    north = origin + [1.0 / 111_000, 0, 0]
    e = tg.lla_to_enu(north, origin)
    assert abs(e[0]) < 1e-6 and 0.99 < e[1] < 1.01 and abs(e[2]) < 1e-3


@pytest.mark.parametrize("batch", [(), (7,), (2, 5)])
def test_batched_rotation_shapes(batch):
    rng = np.random.default_rng(2)
    lat = rng.uniform(-80, 80, batch)
    lon = rng.uniform(-180, 180, batch)
    R = tg._enu_rotation(lat, lon)
    np.testing.assert_array_equal(R, jg._enu_rotation(lat, lon, xp=np))
    assert R.shape == (*batch, 3, 3)
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-12)


def test_enu_tensor_is_float32_local_enu():
    lla, origin = track()
    t = tg.enu_tensor(lla, origin, "cpu")
    assert t.dtype == torch.float32 and t.shape == (len(lla), 3)
    np.testing.assert_array_equal(
        t.numpy(), tg.lla_to_enu(lla, origin).astype(np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tg.enu_tensor(lla, origin, "cuda")
