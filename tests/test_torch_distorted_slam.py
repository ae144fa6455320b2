"""The port's KeyframeSLAM through a distorted OpenCV camera, against the
JAX package's: the 192x144 textured ``line`` scene with radial distortion
[-0.25, 0.08] and exposure jitter (tests/test_slam_e2e.py:527's hard gate
at a small size), and a small TUM RGB-D layout on disk opened by both
packages' ``open_dataset``.

* One step in lockstep, as tests/test_torch_slam.py holds the pinhole
  run: the JAX package tracks the first frames, its state is carried
  into the port, and both run the same frame from the JAX features with
  the JAX draws replayed; the projection and the rays go through the
  OpenCV model.  Slab ids and match decisions equal, inliers within 1,
  the pose within 1e-4; after keyframe insertion and local BA keyframe
  poses within 1e-4 and points within 1e-3.
* The whole run with the JAX package's RANSAC draws replayed frame by
  frame: the same keyframes, inliers within 1 a frame, ATE within 1e-3 m
  of the JAX run's and under the hard gate's 0.20 m (the JAX package's
  own run gives 0.062 m at this size).
* The TUM layout: frames written by chip_smoke.py's writer, read back by
  both players (equal frames), both systems over them: ATE within 0.01 m
  of each other and under 0.05 m.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import write_tum_sequence
from gslam_tpu.app.registry import open_dataset as j_open
from gslam_tpu.eval import evaluate_trajectory as j_eval
from gslam_tpu.models.keyframe_slam import KeyframeSLAM as JSLAM
from gslam_tpu.models.keyframe_slam import SLAMConfig as JConfig
from gslam_tpu.ops.frontend import extract_features as j_extract
from gslam_tpu_torch import convert
from gslam_tpu_torch.app.registry import open_dataset
from gslam_tpu_torch.core.se3 import se3_inverse, se3_mul
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from tests.test_torch_arena import jfields
from tests.test_torch_slam import (
    CFG, carry_state, datasets, port_features, run,
)

torch.set_num_threads(2)

DISTORTED = dict(n_frames=12, n_points=400, width=192, height=144,
                 motion="line", depth=True, texture=True, exposure=0.15,
                 distortion=[-0.25, 0.08])


def test_one_step_in_lockstep_through_the_opencv_model():
    cfg = dict(CFG, kf_min_gap=3, kf_max_gap=3)
    dj, dt = datasets(**dict(DISTORTED, n_frames=8))
    assert dj.camera.model == dt.camera.model == "opencv"
    fj, ft = list(dj), list(dt)
    js = JSLAM(dj.camera, JConfig(**cfg))
    for fr in fj[:6]:
        js.track(fr)
    assert js._n_frames_host == 2 and js.frames_since_kf == 2
    keys = []
    next_key = js._next_key

    def recorded_key():
        keys.append(next_key())
        return keys[-1]

    js._next_key = recorded_key
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**cfg), device="cpu",
                      uniforms=lambda: torch.tensor(np.asarray(
                          jax.random.uniform(keys[-1], (256, 4)))))
    carry_state(js, ts)
    fr_j, fr_t = fj[6], ft[6]
    np.testing.assert_array_equal(fr_t.image, fr_j.image)
    feats_j = j_extract(jnp.asarray(fr_j.image), max_kps=cfg["max_kps"],
                        threshold=cfg["fast_threshold"], use_pallas=False)
    feats_t = port_features(feats_j)
    js._cur_kp_depth = js._kp_depths(fr_j, feats_j)
    js._cur_kp_color = js._kp_colors(fr_j, feats_j)
    ts._cur_kp_depth = ts._kp_depths(torch.tensor(fr_t.depth), feats_t)
    ts._cur_kp_color = ts._kp_colors(torch.tensor(fr_t.image), feats_t)

    T_j, nm_j, ni_j, jump_j = js._track_local_map(feats_j)
    pred = se3_mul(ts.velocity, se3_inverse(ts.pose_wc))
    T_t, nm_t, ni_t, jump_t, nf_t = ts._track_local_map(feats_t, pred)
    slab_j, m_j, inl_j = js._last_track
    slab_t, m_t, inl_t = ts._last_track
    np.testing.assert_array_equal(slab_t.numpy(), np.asarray(slab_j))
    np.testing.assert_array_equal(m_t.idx.numpy(), np.asarray(m_j.idx))
    np.testing.assert_array_equal(m_t.valid.numpy(), np.asarray(m_j.valid))
    assert nm_t == nm_j > 50 and nf_t == int(feats_j.count)
    assert abs(ni_t - ni_j) <= 1 and ni_j > 30
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    np.testing.assert_allclose(jump_t, jump_j, atol=1e-4)

    from gslam_tpu.core import se3 as jse3

    js.velocity = jse3.se3_mul(T_j, js.pose_wc)
    js.pose_wc = jse3.se3_inverse(T_j)
    ts.velocity = se3_mul(T_t, ts.pose_wc)
    ts.pose_wc = se3_inverse(T_t)
    for s in (js, ts):
        s.frames_since_kf += 1
        assert s._need_keyframe(ni_j, nm_j)
    js._insert_keyframe(fr_j, feats_j, T_j)
    ts._insert_keyframe(fr_t, feats_t, T_t)
    assert ts._n_frames_host == js._n_frames_host == 3
    a_j, a_t = jfields(js.arena), convert.arena_to_numpy(ts.arena)
    for name in ("n_frames", "n_points", "n_obs", "obs_frame", "obs_point",
                 "obs_kp", "obs_valid", "point_valid", "point_desc",
                 "frame_valid", "frame_kp_count"):
        np.testing.assert_array_equal(a_t[name], a_j[name], err_msg=name)
    np.testing.assert_allclose(a_t["frame_pose"], a_j["frame_pose"],
                               atol=1e-4)
    np.testing.assert_allclose(a_t["point_xyz"], a_j["point_xyz"],
                               atol=1e-3)


class ReplayedKeys:
    """The JAX package's draws, frame by frame: its keys recorded in a
    run, replayed as the port's (256, 4) uniforms in the same order."""

    def __init__(self):
        self.keys = []

    def record(self, js):
        next_key = js._next_key

        def recorded():
            self.keys.append(next_key())
            return self.keys[-1]

        js._next_key = recorded

    def __call__(self):
        return torch.tensor(np.asarray(jax.random.uniform(self.keys.pop(0),
                                                          (256, 4))))


def test_whole_run_with_the_reference_draws():
    cfg = dict(CFG, kf_max_gap=4)
    dj, dt = datasets(**DISTORTED)
    draws = ReplayedKeys()
    js = JSLAM(dj.camera, JConfig(**cfg))
    draws.record(js)
    t, gt = run(js, dj)
    ate_j = j_eval(t, js.positions(), t, gt, with_scale=False).ate_rmse
    n_draws = len(draws.keys)
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**cfg), device="cpu",
                      uniforms=draws)
    t, gt = run(ts, dt)
    assert draws.keys == [] and n_draws == DISTORTED["n_frames"] - 1
    m = evaluate_trajectory(t, ts.positions(), t, gt, with_scale=False)
    inl_t = [s["n_inliers"] for s in ts.stats]
    inl_j = [s["n_inliers"] for s in js.stats]
    assert ts._n_frames_host == js._n_frames_host >= 3
    assert max(abs(a - b) for a, b in zip(inl_t, inl_j)) <= 1
    assert min(inl_t[1:]) >= 20
    # the hard gate's own bar (0.20 m); with the same draws the two runs
    # agree far inside it
    assert m.ate_rmse < 0.20 and abs(m.ate_rmse - ate_j) <= 1e-3


def test_tum_layout_through_both_players():
    src = SyntheticDataset(**dict(DISTORTED, n_frames=8, width=640,
                                  height=480, n_points=600))
    src.open("synth://")
    with tempfile.TemporaryDirectory() as tmp:
        root = tmp + "/synth_distorted"
        write_tum_sequence(root, list(src), src.camera)
        dj, dt = j_open(root + ".tumrgbd"), open_dataset(root + ".tumrgbd")
        fj, ft = list(dj), list(dt)
    assert dt.camera.model == dj.camera.model == "opencv"
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(b.image, a.image)
        np.testing.assert_array_equal(b.depth, a.depth)
    cfg = dict(CFG, max_kps=256, kf_max_gap=4)
    js = JSLAM(dj.camera, JConfig(**cfg))
    t, gt = run(js, fj)
    ate_j = j_eval(t, js.positions(), t, gt, with_scale=False).ate_rmse
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**cfg), device="cpu")
    t, gt = run(ts, ft)
    m = evaluate_trajectory(t, ts.positions(), t, gt, with_scale=False)
    assert m.n_matched == len(ft) == 8
    assert min(s["n_inliers"] for s in ts.stats[1:]) >= 20
    assert m.ate_rmse < 0.05 and abs(m.ate_rmse - ate_j) <= 0.01
