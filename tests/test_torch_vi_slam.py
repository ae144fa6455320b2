"""The visual-inertial mode of the port's KeyframeSLAM, end to end on the
CPU: the cases of tests/test_slam_e2e.py's TestVisualInertialE2E
(:419-495) and tests/test_loop_closure.py's TestLoopClosureVI (:182-208)
on the port, with the reference's gates, and the 12-frame IMU run's ATE
within 0.01 m of the JAX package's on the same frames (the RANSAC draws
differ); the mono VI alignment's rescale of a carried JAX state, bit for
bit the JAX package's.  The modules under these runs are held against the
JAX package in test_torch_imu.py and test_torch_vi.py, the loop pose
graph's IMU edges in test_torch_loop_closure.py.
"""

import numpy as np
import torch

from gslam_tpu.eval import evaluate_trajectory as j_eval
from gslam_tpu.models.keyframe_slam import KeyframeSLAM as JSLAM
from gslam_tpu.models.keyframe_slam import SLAMConfig as JConfig
from gslam_tpu_torch import convert
from gslam_tpu_torch.core.imu import preintegrate
from gslam_tpu_torch.core.so3 import quat_conj, quat_mul
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from tests.test_torch_loop_closure import ring_vocabulary
from tests.test_torch_arena import jfields
from tests.test_torch_slam import CFG, SMALL, carry_state, datasets, run

torch.set_num_threads(2)


def make_ds(**over):
    ds = SyntheticDataset(**{**SMALL, **over})
    ds.open("synth://")
    return ds


def port_run(ds, cfg):
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**cfg), device="cpu")
    t, gt = run(slam, ds)
    return slam, evaluate_trajectory(t, slam.positions(), t, gt,
                                     with_scale=False)


def test_synthetic_imu_matches_gt_rotation():
    frames = list(make_ds(motion="orbit", imu=True, n_frames=8))
    for a, b in zip(frames[:-1], frames[1:]):
        assert b.imu is not None and len(b.imu) > 1
        d = preintegrate(torch.from_numpy(b.imu))
        q_rel = quat_mul(quat_conj(torch.from_numpy(a.gt_pose[3:7])),
                         torch.from_numpy(b.gt_pose[3:7]))
        assert min((d.dq - q_rel).abs().max(), (d.dq + q_rel).abs().max()) \
            < 2e-3


def test_vi_slam_accumulates_imu_edges():
    dj, dt = datasets(imu=True)
    js = JSLAM(dj.camera, JConfig(**CFG))
    t, gt = run(js, dj)
    ate_j = j_eval(t, js.positions(), t, gt, with_scale=False).ate_rmse
    slam, m = port_run(dt, CFG)
    assert m.ate_rmse < 0.05          # the gyro aid must not hurt the gate
    assert abs(m.ate_rmse - ate_j) <= 0.01
    # every keyframe after the first carries an inertial edge ...
    assert len(slam.imu_edges) >= int(slam.arena.n_frames) - 2
    for (i, j, dq) in slam.imu_edges:
        assert i > j >= 0 and np.isfinite(dq).all() and dq.shape == (4,)
    # ... and a full preintegrated factor (VI BA input)
    assert len(slam.imu_factors) == len(slam.imu_edges)
    for (i, j, f) in slam.imu_factors:
        assert j > i >= 0 and float(f.dt) > 0
        assert slam._imu_factor_idx[(i, j)] is f
    assert "slam/imu" in slam.timer.stats()


def test_vi_init_and_joint_ba():
    """Gravity / velocity alignment, then joint VI BA (the gates of
    tests/test_slam_e2e.py:460-495)."""
    cfg = dict(CFG, vi_min_factors=6, kf_min_gap=2, kf_max_gap=6)
    slam, m = port_run(make_ds(imu=True, n_frames=40), cfg)
    assert slam.vi_ready
    g = np.asarray(slam.gravity_w)
    assert abs(np.linalg.norm(g) - 9.81) < 0.2
    assert float(g @ np.asarray([0.0, 0.0, -9.81])) / (9.81 ** 2) > 0.96
    vels = np.stack(list(slam.kf_vel.values()))
    med = np.median(vels, axis=0)
    assert abs(med[0] - 2.4) < 0.6 and abs(med[1]) < 0.6
    g_dir = g / np.linalg.norm(g)
    v_perp = med - (med @ g_dir) * g_dir
    assert abs(np.linalg.norm(v_perp) - 2.4) < 0.8
    assert np.isfinite(slam.bias_g).all()
    assert m.ate_rmse < 0.10
    # the joint LM ran inside local BA and kept or lowered its cost
    st = slam.timer.stats()
    assert st["slam/vi_local_ba"]["count"] >= 1
    c = slam.vi_costs.numpy()
    assert np.isfinite(c).all() and c[-1] <= c[0]


def test_ring_with_imu_edges():
    """The ring with synthetic IMU and a vocabulary: the inertial
    rotation edges flow into the loop pose graph without destabilizing
    the run."""
    ds = SyntheticDataset(n_frames=48, n_points=500, width=192, height=144,
                          motion="ring", depth=True, radius=6.0,
                          world_extent=5.0, imu=True)
    ds.open("synth://")
    cfg = dict(max_kps=192, fast_threshold=0.1, ba_window=4, ba_points=256,
               ba_iters=3, cap_frames=64, cap_points=4096, cap_obs=16384,
               local_map_size=512, kf_max_gap=4)
    voc_t, _ = ring_vocabulary()
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**cfg), vocabulary=voc_t,
                        device="cpu")
    t, gt = run(slam, ds)
    m = evaluate_trajectory(t, slam.positions(), t, gt, with_scale=False)
    assert m.ate_rmse < 4.0
    assert len(slam.imu_edges) >= slam.loop_closer.n_kf - 2


def test_map_scale_as_the_reference_applies_it():
    """Mono VI alignment's rescale (``_apply_map_scale``): the JAX
    package's mapped state carried into the port, both rescaled by the
    same factor: keyframe translations, points, keypoint depths, the pose,
    the motion model and the recorded trajectory scale; rotations do not."""
    dj, dt = datasets(n_frames=6)
    js = JSLAM(dj.camera, JConfig(**CFG))
    run(js, dj)
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**CFG), device="cpu")
    carry_state(js, ts)
    ts.trajectory = [torch.tensor(p) for p in js.trajectory]
    js._apply_map_scale(2.5)
    ts._apply_map_scale(2.5)
    a_j, a_t = jfields(js.arena), convert.arena_to_numpy(ts.arena)
    for name in ("frame_pose", "point_xyz", "frame_kp_depth"):
        np.testing.assert_array_equal(a_t[name], a_j[name], name)
    np.testing.assert_array_equal(ts.pose_wc.numpy(), np.asarray(js.pose_wc))
    np.testing.assert_array_equal(ts.velocity.numpy(),
                                  np.asarray(js.velocity))
    np.testing.assert_array_equal(torch.stack(ts.trajectory).numpy(),
                                  np.stack(js.trajectory))
