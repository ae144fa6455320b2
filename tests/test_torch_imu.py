"""The port's IMU preintegration (gslam_tpu_torch.core.imu) against the
JAX package's (gslam_tpu.core.imu), on the analytic trajectory of
tests/test_vi.py.

Each case of tests/test_vi.py:85-176 runs in both packages on the same
samples; every field of the port's factor is within 1e-5 of the JAX
package's, relative to the field's largest magnitude (float32
recursions over up to 400 samples, matrix products in another order),
and the reference's own assertion holds on the port's factor.  A window
padded to the JAX package's power-of-two bucket gives the port the same
factor as the unpadded one, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.core import imu as jimu
from gslam_tpu_torch.core import imu
from gslam_tpu_torch.core.so3 import quat_mul, so3_exp
from tests.test_vi import gt_factor, make_imu_window

RTOL = 1e-5


def assert_close_rel(t, j, what=""):
    """Port tensor ``t`` within RTOL of JAX array ``j``, relative to the
    largest magnitude of ``j``."""
    j = np.asarray(j, np.float64)
    t = t.detach().cpu().numpy().astype(np.float64)
    scale = max(np.abs(j).max(), 1e-30)
    assert np.abs(t - j).max() <= RTOL * scale, \
        f"{what}: {np.abs(t - j).max()} > {RTOL} * {scale}"


def assert_factor_close(ft, fj):
    for k in jimu.ImuFactor._fields:
        assert_close_rel(getattr(ft, k), getattr(fj, k), k)


def both_full(s, valid=None, **kw):
    v = np.ones(len(s), bool) if valid is None else valid
    fj = jimu.preintegrate_full(jnp.asarray(s), jnp.asarray(v), **kw)
    ft = imu.preintegrate_full(torch.from_numpy(s), torch.from_numpy(v), **kw)
    assert_factor_close(ft, fj)
    return ft, fj


def test_matches_ground_truth():
    s = make_imu_window(0.0, 0.5)
    f, _ = both_full(s)
    dq_gt, dv_gt, dp_gt = gt_factor(0.0, 0.5)
    assert abs(abs(float(np.dot(f.dq.numpy(), dq_gt))) - 1.0) < 1e-4
    np.testing.assert_allclose(f.dv.numpy(), dv_gt, atol=2e-2)
    np.testing.assert_allclose(f.dp.numpy(), dp_gt, atol=1e-2)
    assert abs(float(f.dt) - 0.5) < 1e-3


def test_matches_light_preintegrate():
    s = make_imu_window(0.0, 0.3)
    f, _ = both_full(s)
    dj = jimu.preintegrate(jnp.asarray(s), jnp.ones(len(s), bool))
    d = imu.preintegrate(torch.from_numpy(s))
    for k in jimu.ImuDelta._fields:
        assert_close_rel(getattr(d, k), getattr(dj, k), k)
    np.testing.assert_allclose(f.dq.numpy(), d.dq.numpy(), atol=1e-6)
    np.testing.assert_allclose(f.dv.numpy(), d.dv.numpy(), atol=1e-5)
    np.testing.assert_allclose(f.dp.numpy(), d.dp.numpy(), atol=1e-5)


def test_light_preintegrate_with_biases():
    s = make_imu_window(0.0, 0.3)
    bg = np.array([0.01, 0.005, -0.008], np.float32)
    ba = np.array([0.05, -0.03, 0.02], np.float32)
    dj = jimu.preintegrate(jnp.asarray(s), jnp.ones(len(s), bool),
                           jnp.asarray(bg), jnp.asarray(ba))
    d = imu.preintegrate(torch.from_numpy(s), None, torch.from_numpy(bg),
                         torch.from_numpy(ba))
    for k in jimu.ImuDelta._fields:
        assert_close_rel(getattr(d, k), getattr(dj, k), k)


def test_covariance_grows_and_spd():
    kw = dict(gyro_noise=1e-3, accel_noise=1e-2)
    f, _ = both_full(make_imu_window(0.0, 1.0), **kw)
    cov = f.cov.numpy()
    assert np.allclose(cov, cov.T, atol=1e-12)
    assert (np.linalg.eigvalsh(cov) > -1e-12).all()
    assert cov[0, 0] > 0 and cov[4, 4] > 0 and cov[8, 8] > 0
    f2, _ = both_full(make_imu_window(0.0, 2.0), **kw)
    assert float(f2.cov[8, 8]) > float(f.cov[8, 8])


def test_invalid_samples_ignored():
    s = make_imu_window(0.0, 0.5)
    v = np.ones(len(s), bool)
    v[len(s) // 2:] = False
    f, _ = both_full(s, v)
    assert abs(float(f.dt) - s[len(s) // 2 - 1, 0]) < 1e-2


def test_padded_window_gives_the_same_factor():
    """The JAX package pads a frame's window to a power-of-two bucket of
    at least 8 rows with invalid zero rows; the port steps over the
    samples it is given.  Both give the same factor, bit for bit, and the
    JAX package's padded factor to RTOL."""
    s = make_imu_window(0.0, 1.0 / 30.0, hz=300.0)   # 11 samples
    m = len(s)
    cap = 16
    pad = np.zeros((cap, 7), np.float32)
    pad[:m] = s
    valid = np.zeros(cap, bool)
    valid[:m] = True
    f_pad = imu.preintegrate_full(torch.from_numpy(pad),
                                  torch.from_numpy(valid))
    f_one = imu.preintegrate_full(torch.from_numpy(s))
    for k in imu.ImuFactor._fields:
        assert torch.equal(getattr(f_pad, k), getattr(f_one, k)), k
    fj = jimu.preintegrate_full(jnp.asarray(pad), jnp.asarray(valid))
    assert_factor_close(f_one, fj)


def test_compose_equals_full_window():
    fa, ja = both_full(make_imu_window(0.0, 0.4))
    fb, jb = both_full(make_imu_window(0.4, 0.9))
    fc = imu.compose_factors(fa, fb)
    assert_factor_close(fc, jimu.compose_factors(ja, jb))
    f, _ = both_full(make_imu_window(0.0, 0.9))
    np.testing.assert_allclose(fc.dv.numpy(), f.dv.numpy(), atol=3e-2)
    np.testing.assert_allclose(fc.dp.numpy(), f.dp.numpy(), atol=3e-2)
    assert abs(abs(float(fc.dq @ f.dq)) - 1.0) < 1e-4
    np.testing.assert_allclose(fc.J_v_ba.numpy(), f.J_v_ba.numpy(),
                               atol=1e-2)
    np.testing.assert_allclose(fc.J_R_bg.numpy(), f.J_R_bg.numpy(),
                               atol=1e-2)


def test_bias_jacobian_first_order():
    s = make_imu_window(0.0, 0.5)
    f0, _ = both_full(s)
    ba = np.array([0.05, -0.03, 0.02], np.float32)
    bg = np.array([0.01, 0.005, -0.008], np.float32)
    s_b = s.copy()
    s_b[:, 1:4] -= ba
    s_b[:, 4:7] -= bg
    f_b, _ = both_full(s_b)
    bg_t, ba_t = torch.from_numpy(bg), torch.from_numpy(ba)
    dv_corr = f0.dv + f0.J_v_bg @ bg_t + f0.J_v_ba @ ba_t
    dp_corr = f0.dp + f0.J_p_bg @ bg_t + f0.J_p_ba @ ba_t
    np.testing.assert_allclose(dv_corr.numpy(), f_b.dv.numpy(), atol=5e-3)
    np.testing.assert_allclose(dp_corr.numpy(), f_b.dp.numpy(), atol=5e-3)
    dq_corr = quat_mul(f0.dq, so3_exp(f0.J_R_bg @ bg_t))
    assert abs(abs(float(dq_corr @ f_b.dq)) - 1.0) < 1e-5


@pytest.mark.parametrize("weight", [1.0, 5.0])
def test_predict_pose_and_rotation_edge(weight):
    from gslam_tpu.core.se3 import se3_make as jse3_make

    s = make_imu_window(0.0, 0.4)
    dj = jimu.preintegrate(jnp.asarray(s), jnp.ones(len(s), bool))
    d = imu.preintegrate(torch.from_numpy(s))
    pose = np.array([0.3, -0.2, 1.0, 0.9, 0.1, -0.3, 0.2], np.float32)
    pose[3:] /= np.linalg.norm(pose[3:])
    vel = np.array([0.5, 1.0, -0.2], np.float32)
    pj = jimu.predict_pose(jse3_make(jnp.asarray(pose[:3]),
                                     jnp.asarray(pose[3:])),
                           jnp.asarray(vel), dj)
    pt = imu.predict_pose(torch.from_numpy(pose), torch.from_numpy(vel), d)
    assert_close_rel(pt, pj, "pose")
    Zj, wj = jimu.imu_rotation_edge(dj, weight=weight)
    Zt, wt = imu.imu_rotation_edge(d, weight=weight)
    assert_close_rel(Zt, Zj, "Z")
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_identity_factor():
    fj = jimu.identity_factor()
    ft = imu.identity_factor()
    for k in jimu.ImuFactor._fields:
        np.testing.assert_array_equal(getattr(ft, k).numpy(),
                                      np.asarray(getattr(fj, k)), k)
