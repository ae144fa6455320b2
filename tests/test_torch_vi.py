"""The port's visual-inertial estimation (gslam_tpu_torch.opt.vi) against
the JAX package's (gslam_tpu.opt.vi), on the problems of
tests/test_vi.py:204-345 fed to both through
``convert.vi_problem_from_numpy``.

Tolerances (float32 LM on both sides; the IMU Jacobians are forward-mode
derivatives on both sides, the sums run in another order): the cost
history within rtol 5e-3 of the JAX package's (atol 1e-6 of the first
cost, the noise floor a converged window reaches), keyframe poses,
velocities and biases within 1e-4, landmarks within 2e-4 and the
refined gravity within 1e-5 (m/s^2).  The reference's own assertions
hold on the port's output.  The linear gravity / velocity / scale
alignment runs on the host in float64 in both packages and agrees to
1e-6.  An indefinite system's step is rejected, as in the JAX package,
and nothing in the LM reads a value back to the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.core.imu import identity_factor as j_identity_factor
from gslam_tpu.opt import vi as jvi
from gslam_tpu_torch import convert
from gslam_tpu_torch.core.so3 import quat_rotate
from gslam_tpu_torch.opt import vi
from tests.test_torch_batch import HostReads
from tests.test_vi import G_W, TestViBundleAdjust, make_keyframes

torch.set_num_threads(2)


def bad_gravity(prob):
    ang = np.deg2rad(5.0)
    g = np.array([np.sin(ang), 0.0, -np.cos(ang)]) * 9.81
    return prob._replace(gravity_w=jnp.asarray(g, jnp.float32))


# (problem overrides, vi_bundle_adjust arguments) of tests/test_vi.py's
# TestViBundleAdjust cases
CASES = {
    "reduces_cost": (dict(), dict(iters=10)),
    "velocity_from_imu": (dict(pose_noise=0.0, vel_noise=0.5),
                          dict(iters=10)),
    "gravity_refinement": (dict(pose_noise=0.01, vel_noise=0.1),
                           dict(iters=12, refine_gravity=True)),
}


def problems(name):
    over, kw = CASES[name]
    prob, poses_gt, vels_gt = TestViBundleAdjust()._make_problem(**over)
    if name == "gravity_refinement":
        prob = bad_gravity(prob)
    return prob, convert.vi_problem_from_numpy(prob, device="cpu"), kw, \
        poses_gt, vels_gt


def assert_like_reference(out_t, costs_t, out_j, costs_j):
    cj = np.asarray(costs_j)
    np.testing.assert_allclose(costs_t.numpy(), cj, rtol=5e-3,
                               atol=1e-6 * cj[0])
    for name, tol in (("vel", 1e-4), ("bias_g", 1e-4), ("bias_a", 1e-4),
                      ("gravity_w", 1e-5)):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(out_t.vision.cam_pose.numpy(),
                               np.asarray(out_j.vision.cam_pose), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out_t.vision.point_xyz.numpy(),
                               np.asarray(out_j.vision.point_xyz), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_vi_bundle_adjust_against_reference(name):
    prob_j, prob_t, kw, poses_gt, vels_gt = problems(name)
    out_j, costs_j = jvi.vi_bundle_adjust(prob_j, **kw)
    out_t, costs_t = vi.vi_bundle_adjust(prob_t, **kw)
    assert_like_reference(out_t, costs_t, out_j, costs_j)
    costs = costs_t.numpy()
    verr0 = np.linalg.norm(prob_t.vel.numpy() - vels_gt, axis=-1).mean()
    verr1 = np.linalg.norm(out_t.vel.numpy() - vels_gt, axis=-1).mean()
    if name == "reduces_cost":
        assert costs[-1] < 0.1 * costs[0]
        err = [np.linalg.norm(p[:, :3] - poses_gt[:, :3], axis=-1).mean()
               for p in (prob_t.vision.cam_pose.numpy(),
                         out_t.vision.cam_pose.numpy())]
        assert err[1] < 0.3 * err[0]
        assert verr1 < 0.15
    elif name == "velocity_from_imu":
        assert verr1 < 0.3 * verr0
    else:
        g_ref = out_t.gravity_w.numpy()
        g_bad = prob_t.gravity_w.numpy()
        assert abs(np.linalg.norm(g_ref) - 9.81) < 1e-3
        cos_after = float(g_ref @ G_W) / (9.81 * 9.81)
        assert cos_after > float(g_bad @ G_W) / (9.81 * 9.81)
        assert np.degrees(np.arccos(min(cos_after, 1.0))) < 2.0


def test_kernel_route_takes_plain_versions_on_cpu_tensors():
    """``use_kernels`` on CPU tensors: the B5 / B6 wrappers take their
    plain versions, so the result is the plain LM's bit for bit."""
    _, prob_t, kw, _, _ = problems("gravity_refinement")
    out_k, costs_k = vi.vi_bundle_adjust(prob_t, use_kernels=True, **kw)
    out_p, costs_p = vi.vi_bundle_adjust(prob_t, **kw)
    assert torch.equal(costs_k, costs_p)
    assert torch.equal(out_k.vision.cam_pose, out_p.vision.cam_pose)
    assert torch.equal(out_k.gravity_w, out_p.gravity_w)


def test_warm_start_holds_poses_and_points():
    """The first ``warm_start`` iterations move velocities and biases
    only."""
    prob_j, prob_t, _, _, _ = problems("reduces_cost")
    out_t, costs_t = vi.vi_bundle_adjust(prob_t, iters=2, warm_start=2)
    out_j, costs_j = jvi.vi_bundle_adjust(prob_j, iters=2, warm_start=2)
    assert torch.equal(out_t.vision.cam_pose, prob_t.vision.cam_pose)
    assert torch.equal(out_t.vision.point_xyz, prob_t.vision.point_xyz)
    assert not torch.equal(out_t.vel, prob_t.vel)
    assert_like_reference(out_t, costs_t, out_j, costs_j)


def test_invalid_pairs_are_inert():
    """A pad factor with pair_valid False changes nothing, in the port
    as in the JAX package."""
    prob_j, prob_t, _, _, _ = problems("reduces_cost")
    pad = jvi.stack_factors([j_identity_factor()])
    prob_pad = prob_j._replace(
        pair_i=jnp.concatenate([prob_j.pair_i, jnp.asarray([-1])]),
        pair_j=jnp.concatenate([prob_j.pair_j, jnp.asarray([-1])]),
        pair_valid=jnp.concatenate([prob_j.pair_valid,
                                    jnp.asarray([False])]),
        imu=jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]),
                                   prob_j.imu, pad))
    pad_t = convert.vi_problem_from_numpy(prob_pad, device="cpu")
    out0, c0 = vi.vi_bundle_adjust(prob_t, iters=4)
    out1, c1 = vi.vi_bundle_adjust(pad_t, iters=4)
    np.testing.assert_allclose(out0.vision.cam_pose.numpy(),
                               out1.vision.cam_pose.numpy(), atol=1e-4)
    out_j, costs_j = jvi.vi_bundle_adjust(prob_pad, iters=4)
    assert_like_reference(out1, c1, out_j, costs_j)


def test_indefinite_system_rejects_every_step_without_host_reads():
    """A factor whose covariance is negative definite makes H indefinite:
    the Cholesky factor fails, the step is NaN and rejected (the JAX
    package's quirk at gslam_tpu/opt/vi.py:275, kept), the state and cost
    stay and lambda grows; the port reads nothing back to the host on
    the way."""
    prob_j, _, _, _, _ = problems("reduces_cost")
    neg = jnp.asarray(prob_j.imu.cov).at[0].set(-1e-4 * jnp.eye(9))
    prob_j = prob_j._replace(imu=prob_j.imu._replace(cov=neg))
    prob_t = convert.vi_problem_from_numpy(prob_j, device="cpu")
    guard = HostReads()
    with guard:
        out_t, costs_t = vi.vi_bundle_adjust(prob_t, iters=4, warm_start=1)
    assert guard.found == []
    out_j, costs_j = jvi.vi_bundle_adjust(prob_j, iters=4, warm_start=1)
    np.testing.assert_array_equal(np.asarray(costs_j),
                                  np.full(5, np.asarray(costs_j)[0]))
    assert torch.equal(costs_t, costs_t[:1].expand(5))
    np.testing.assert_allclose(costs_t.numpy(), np.asarray(costs_j),
                               rtol=1e-5)
    for name in ("vel", "bias_g", "bias_a"):
        assert torch.equal(getattr(out_t, name), getattr(prob_t, name))
    assert torch.equal(out_t.vision.cam_pose, prob_t.vision.cam_pose)


def test_recovers_gravity_and_velocity():
    poses, vels_gt, imu_j = make_keyframes()
    n = poses.shape[0]
    g_j, vel_j, s_j = jvi.estimate_gravity_velocity(
        jnp.asarray(poses), jnp.arange(n - 1), jnp.arange(1, n), imu_j)
    imu_t = convert.imu_factor_from_numpy(imu_j, device="cpu")
    g, vel, s = vi.estimate_gravity_velocity(
        torch.from_numpy(poses), np.arange(n - 1), np.arange(1, n), imu_t)
    np.testing.assert_allclose(g, g_j, atol=1e-6)
    np.testing.assert_allclose(vel, vel_j, atol=1e-6)
    assert s == s_j == 1.0
    np.testing.assert_allclose(g, G_W, atol=0.15)
    np.testing.assert_allclose(vel, vels_gt, atol=0.1)


@pytest.mark.parametrize("fix_magnitude", [True, False])
def test_recovers_scale(fix_magnitude):
    poses, vels_gt, imu_j = make_keyframes()
    n = poses.shape[0]
    scaled = poses.copy()
    scaled[:, :3] *= 0.5   # vision map at half metric scale
    args = (np.arange(n - 1), np.arange(1, n))
    g_j, vel_j, s_j = jvi.estimate_gravity_velocity(
        jnp.asarray(scaled), *args, imu_j, with_scale=True,
        fix_magnitude=fix_magnitude)
    g, vel, s = vi.estimate_gravity_velocity(
        scaled, *args, convert.imu_factor_from_numpy(imu_j, device="cpu"),
        with_scale=True, fix_magnitude=fix_magnitude)
    np.testing.assert_allclose(g, g_j, atol=1e-6)
    np.testing.assert_allclose(vel, vel_j, atol=1e-6)
    assert abs(s - s_j) < 1e-6
    assert abs(s - 2.0) < 0.2
    np.testing.assert_allclose(g, G_W, atol=0.2)


@pytest.mark.parametrize("g_est", [[1.0, 0.5, -9.6], [0.0, 0.0, -9.81],
                                   [0.0, 0.0, 9.81], [0.0, 0.0, 0.0]])
def test_gravity_align_rotation(g_est):
    g_est = np.asarray(g_est)
    q = vi.gravity_align_rotation(g_est)
    np.testing.assert_array_equal(q, jvi.gravity_align_rotation(g_est))
    if np.linalg.norm(g_est) > 0:
        g_rot = quat_rotate(torch.from_numpy(q),
                            torch.tensor(g_est, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(g_rot / np.linalg.norm(g_rot),
                                   [0, 0, -1], atol=1e-5)


@pytest.mark.parametrize("name", ["reduces_cost", "gravity_refinement"])
def test_card_window_is_the_reference_window(name):
    """chip_smoke.vi_case, the windows of the card tests of the VI LM, are
    tests/test_vi.py's, built without JAX: the same poses, velocities and
    gravity, factors to RTOL of the JAX package's, the same landmark
    draws."""
    from chip_smoke import vi_case

    card = dict(gravity_refinement=dict(pose_noise=0.01, vel_noise=0.1,
                                        tilt_deg=5.0)).get(name, {})
    prob, poses, vels = vi_case(device="cpu", **card)
    prob_j, _, _, poses_j, vels_j = problems(name)
    np.testing.assert_allclose(prob.gravity_w.numpy(),
                               np.asarray(prob_j.gravity_w), atol=1e-6)
    np.testing.assert_allclose(poses, poses_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vels, vels_j, rtol=0, atol=1e-6)
    for k, x in prob.imu._asdict().items():
        j = np.asarray(getattr(prob_j.imu, k))
        assert np.abs(x.numpy() - j).max() <= 1e-5 * np.abs(j).max(), k
    for k in ("cam_fixed", "obs_cam", "obs_valid"):
        np.testing.assert_array_equal(getattr(prob.vision, k).numpy(),
                                      np.asarray(getattr(prob_j.vision, k)))
    for k in ("cam_pose", "point_xyz", "obs_uv", "obs_weight"):
        np.testing.assert_allclose(getattr(prob.vision, k).numpy(),
                                   np.asarray(getattr(prob_j.vision, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(prob.vel.numpy(), np.asarray(prob_j.vel),
                               atol=1e-6)


def test_stack_factors_from_numpy_and_tensors():
    from gslam_tpu_torch.core.imu import identity_factor

    f = identity_factor()
    f_np = type(f)(*(x.numpy() for x in f))
    a = vi.stack_factors([f, f])
    b = vi.stack_factors([f_np, f_np], device="cpu")
    for x, y in zip(a, b):
        assert x.shape[0] == 2 and torch.equal(x, y)
