"""The port's synthetic dataset, trajectory evaluation, Umeyama
alignment, pinhole Camera, Sim(3) group operations and timer against the
JAX package's (the other lens models: test_torch_camera.py).

Tolerances: images, depth maps, ground-truth poses and IMU windows bit
for bit (the same numpy arithmetic; the ray table's float32 division in
the same order); associations equal; ATE, RPE and scale to 1e-5
relative (float32 SVD on both sides); alignment and Sim(3) results to
1e-5; camera projections to 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.core import sim3 as js
from gslam_tpu.core.camera import Camera as JCamera
from gslam_tpu.datasets.synthetic import SyntheticDataset as JData
from gslam_tpu.estimation.alignment import umeyama_alignment as j_umeyama
from gslam_tpu.eval import trajectory as jt
from gslam_tpu_torch.core import sim3 as ts
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.estimation.alignment import umeyama_alignment
from gslam_tpu_torch.eval import trajectory as tt
from gslam_tpu_torch.utils.timer import Timer

torch.set_num_threads(2)

CASES = [
    dict(n_frames=4, n_points=300, width=192, height=144, motion="line",
         depth=True),
    dict(n_frames=3, n_points=400, width=160, height=120,
         motion="ring_out", depth=True, texture=True, radius=14.0,
         world_extent=8.0, noise=0.01),
    dict(n_frames=3, n_points=200, width=128, height=96, motion="line",
         depth=True, texture=True),
    dict(n_frames=3, n_points=250, width=128, height=96, motion="orbit",
         stereo=True, depth=False, exposure=0.2, imu=True, imu_noise=0.01),
    dict(n_frames=6, n_points=150, width=96, height=64, motion="ring",
         laps=2, imu=True),
]


@pytest.mark.parametrize("cfg", CASES, ids=lambda c: c["motion"])
def test_dataset_bit_equal(cfg):
    a = JData(**cfg)
    b = SyntheticDataset(**cfg)
    assert a.open("synth://") and b.open("synth://")
    assert len(a) == len(b) == cfg["n_frames"]
    np.testing.assert_array_equal(b.camera.params, a.camera.params)
    n = 0
    for fa, fb in zip(a, b):
        assert (fa.id, fa.timestamp) == (fb.id, fb.timestamp)
        for name in ("image", "depth", "gt_pose", "image_right", "imu"):
            va, vb = getattr(fa, name), getattr(fb, name)
            assert (va is None) == (vb is None), name
            if va is not None:
                assert va.dtype == vb.dtype, name
                np.testing.assert_array_equal(vb, va, err_msg=name)
        assert fb.stereo_baseline == fa.stereo_baseline
        n += 1
    assert n == cfg["n_frames"]


def test_dataset_json_config_and_distortion(tmp_path):
    p = tmp_path / "seq.synth"
    p.write_text('{"n_frames": 2, "n_points": 50, "width": 64, '
                 '"height": 48, "motion": "line"}')
    a, b = JData(), SyntheticDataset()
    a.open(str(p))
    b.open(str(p))
    np.testing.assert_array_equal(next(iter(b)).image, next(iter(a)).image)
    # radial distortion renders through the OpenCV camera, as in the JAX
    # package (the textured frames are held in test_torch_datasets.py)
    d = SyntheticDataset(distortion=[0.1, 0.0], n_frames=1, width=64,
                         height=48)
    dj = JData(distortion=[0.1, 0.0], n_frames=1, width=64, height=48)
    assert d.open("synth://") and dj.open("synth://")
    assert d.camera.model == dj.camera.model == "opencv"
    np.testing.assert_array_equal(d.camera.params, dj.camera.params)
    np.testing.assert_array_equal(next(iter(d)).image, next(iter(dj)).image)


def trajectory_pair(rng, n=60):
    t = np.arange(n) / 30.0
    gt = np.stack([np.cos(t), 0.3 * np.sin(2 * t), 0.1 * t], -1)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    S = np.concatenate([[0.5, -0.2, 1.0], q, [1.7]]).astype(np.float32)
    est = np.asarray(js.sim3_apply(jnp.asarray(S), jnp.asarray(
        gt, jnp.float32))) + rng.normal(0, 0.01, gt.shape)
    t_est = t + rng.uniform(-0.004, 0.004, n)
    return t_est, est.astype(np.float32), t, gt.astype(np.float32)


@pytest.mark.parametrize("with_scale", [True, False])
def test_ate_on_a_fixed_trajectory_pair(with_scale):
    t_est, est, t_gt, gt = trajectory_pair(np.random.default_rng(1))
    mj = jt.evaluate_trajectory(t_est[:-3], est[:-3], t_gt, gt,
                                with_scale=with_scale, rpe_delta=2)
    mt = tt.evaluate_trajectory(t_est[:-3], est[:-3], t_gt, gt,
                                with_scale=with_scale, rpe_delta=2)
    assert mt.n_matched == mj.n_matched == 57
    for name in ("ate_rmse", "rpe_rmse", "rpe_mean", "scale"):
        np.testing.assert_allclose(getattr(mt, name), getattr(mj, name),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(tt.ate_rmse(est, gt, with_scale),
                               jt.ate_rmse(est, gt, with_scale), rtol=1e-5)
    ie_t, ig_t = tt.associate(t_est, t_gt[::2])
    ie_j, ig_j = jt.associate(t_est, t_gt[::2])
    np.testing.assert_array_equal(ie_t, ie_j)
    np.testing.assert_array_equal(ig_t, ig_j)
    assert tt.evaluate_trajectory(t_est[:2], est[:2], t_gt, gt).ate_rmse \
        == np.inf


def test_umeyama_and_sim3_group():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(30, 3)).astype(np.float32)
    dst = (src @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T * 0.8
           + 1.0).astype(np.float32)
    w = rng.uniform(0.2, 1.0, 30).astype(np.float32)
    for ws in (True, False):
        a = umeyama_alignment(torch.tensor(src), torch.tensor(dst),
                              torch.tensor(w), with_scale=ws).numpy()
        b = np.asarray(j_umeyama(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(w), with_scale=ws))
        if np.sign(a[3]) != np.sign(b[3]):     # q and -q: one rotation
            a[3:7] = -a[3:7]
        np.testing.assert_allclose(a, b, atol=1e-5)
    q = rng.normal(size=(4, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    A = np.concatenate([rng.normal(size=(4, 3)), q,
                        rng.uniform(0.5, 2, (4, 1))], 1).astype(np.float32)
    B = A[::-1].copy()
    x = rng.normal(size=(4, 3)).astype(np.float32)
    At, Bt, Aj, Bj = torch.tensor(A), torch.tensor(B), jnp.asarray(A), \
        jnp.asarray(B)
    for got, ref in (
            (ts.sim3_mul(At, Bt), js.sim3_mul(Aj, Bj)),
            (ts.sim3_inverse(At), js.sim3_inverse(Aj)),
            (ts.sim3_apply(At, torch.tensor(x)), js.sim3_apply(Aj, x)),
            (ts.sim3_from_se3(At[:, :7]), js.sim3_from_se3(Aj[:, :7])),
            (ts.sim3_to_se3(At), js.sim3_to_se3(Aj)),
            (ts.sim3_identity((2,), device="cpu"),
             js.sim3_identity((2,)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ts.sim3_identity()


def test_pinhole_camera():
    a = JCamera.from_fov(640, 480, 70.0)
    b = Camera.from_fov(640, 480, 70.0)
    np.testing.assert_array_equal(b.params, a.params)
    assert (b.fx, b.fy, b.cx, b.cy) == (a.fx, a.fy, a.cx, a.cy)
    rng = np.random.default_rng(3)
    p = np.concatenate([rng.uniform(-3, 3, (50, 2)),
                        rng.uniform(-1, 8, (50, 1))], 1).astype(np.float32)
    uv_j, ok_j = a.project(jnp.asarray(p))
    uv_t, ok_t = b.project(torch.tensor(p))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6)
    np.testing.assert_allclose(b.unproject(uv_t).numpy(),
                               np.asarray(a.unproject(uv_j)), rtol=1e-6,
                               atol=1e-7)
    # the lens models are ported (test_torch_camera.py); an unknown model
    # raises as in the JAX package
    assert Camera("opencv", 64, 48, [1, 1, 1, 1, 0, 0, 0, 0, 0]).model \
        == "opencv"
    with pytest.raises(ValueError, match="unknown camera model"):
        Camera("fisheye", 64, 48, [1, 1, 1, 1])


def test_timer_sections():
    tm = Timer()
    for _ in range(3):
        with tm.section("slam/extract"):
            torch.zeros(2).add_(1)
    st = tm.stats()["slam/extract"]
    assert st["count"] == 3 and st["total"] >= st["max"] >= st["min"] >= 0
    assert st["kind"] == "span" and st["parent"] is None
    assert "slam/extract" in tm.table()
    with pytest.raises(KeyError):
        tm.leave("nope")
    tm.reset()
    assert tm.stats() == {}
