"""The port's KeyframeSLAM (gslam_tpu_torch.models.keyframe_slam) against
the JAX package's, on the synthetic sequences of tests/test_slam_e2e.py.

* One step in lockstep: the JAX package tracks the first frames; its map
  arena, pose, motion model and counters are carried into the port
  through gslam_tpu_torch.convert, and both then run the same frame from
  the JAX features, with the JAX package's RANSAC draws replayed into the
  port: the fused track, the keyframe insertion and the local BA.  Slab
  ids, match decisions and observation tables are equal; the inlier
  count is within 1 and the pose within 1e-4 (float32 P3P, see
  test_torch_pnp.py); after the keyframe and local BA the keyframe poses
  agree to 1e-4 and the map points to 1e-3 (float32 LM on both sides).
* The whole slice: both packages run the e2e sequence end to end; the
  port's ATE meets the JAX e2e gate (0.05 m) and differs from the JAX
  run's by at most 0.01 m (the frontends differ by an ulp in blur, which
  moves a few keypoints; the RANSAC draws differ).
* The frame-store capacity edge: both packages drop the keyframes past
  ``cap_frames`` and raise the overflow flag.
* The paths that are not ported raise NotImplementedError; a BA window
  wider than the Schur kernel takes runs the plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.datasets.synthetic import SyntheticDataset as JData
from gslam_tpu.eval import evaluate_trajectory as j_eval
from gslam_tpu.models.keyframe_slam import KeyframeSLAM as JSLAM
from gslam_tpu.models.keyframe_slam import SLAMConfig as JConfig
from gslam_tpu.ops.frontend import extract_features as j_extract
from gslam_tpu_torch import convert
from gslam_tpu_torch.core.se3 import se3_inverse, se3_mul
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.ops.frontend import Features
from tests.test_torch_arena import jfields

torch.set_num_threads(2)

SMALL = dict(n_frames=12, n_points=300, width=192, height=144,
             motion="line", depth=True)
CFG = dict(max_kps=192, fast_threshold=0.1, ba_window=4, ba_points=256,
           ba_iters=3, cap_frames=32, cap_points=2048, cap_obs=8192,
           local_map_size=384)


def datasets(**over):
    a, b = JData(**{**SMALL, **over}), SyntheticDataset(**{**SMALL, **over})
    a.open("synth://")
    b.open("synth://")
    return a, b


def carry_state(js: JSLAM, ts: KeyframeSLAM) -> None:
    ts.arena = convert.arena_from_numpy(jfields(js.arena), device="cpu")
    ts.pose_wc = torch.tensor(np.asarray(js.pose_wc))
    ts.velocity = torch.tensor(np.asarray(js.velocity))
    for name in ("last_kf_id", "frames_since_kf", "initialized",
                 "_n_frames_host", "_n_points_host"):
        setattr(ts, name, getattr(js, name))


def port_features(f) -> Features:
    d = {k: np.asarray(v) for k, v in f._asdict().items()}
    d["desc"] = convert.desc_from_numpy(d["desc"], "cpu")
    return Features(**{k: v if torch.is_tensor(v) else torch.tensor(v)
                       for k, v in d.items()})


def test_one_step_in_lockstep():
    cfg = dict(CFG, kf_min_gap=3, kf_max_gap=3)
    dj, dt = datasets(n_frames=8)
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
    feats_j = j_extract(jnp.asarray(fr_j.image), max_kps=cfg["max_kps"],
                        threshold=cfg["fast_threshold"], use_pallas=False)
    feats_t = port_features(feats_j)
    js._cur_kp_depth = js._kp_depths(fr_j, feats_j)
    js._cur_kp_color = js._kp_colors(fr_j, feats_j)
    ts._cur_kp_depth = ts._kp_depths(torch.tensor(fr_t.depth), feats_t)
    ts._cur_kp_color = ts._kp_colors(torch.tensor(fr_t.image), feats_t)
    np.testing.assert_array_equal(ts._cur_kp_depth.numpy(),
                                  np.asarray(js._cur_kp_depth))
    np.testing.assert_array_equal(ts._cur_kp_color.numpy(),
                                  np.asarray(js._cur_kp_color))

    # the fused track
    T_j, nm_j, ni_j, jump_j = js._track_local_map(feats_j)
    pred = se3_mul(ts.velocity, se3_inverse(ts.pose_wc))
    T_t, nm_t, ni_t, jump_t, nf_t = ts._track_local_map(feats_t, pred)
    slab_j, m_j, inl_j = js._last_track
    slab_t, m_t, inl_t = ts._last_track
    np.testing.assert_array_equal(slab_t.numpy(), np.asarray(slab_j))
    np.testing.assert_array_equal(m_t.idx.numpy(), np.asarray(m_j.idx))
    np.testing.assert_array_equal(m_t.valid.numpy(), np.asarray(m_j.valid))
    assert nm_t == nm_j > 50 and nf_t == int(feats_j.count)
    assert abs(ni_t - ni_j) <= 1 and ni_j > 50
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    np.testing.assert_allclose(jump_t, jump_j, atol=1e-4)
    for name in ("point_visible", "point_found"):
        np.testing.assert_array_equal(getattr(ts.arena, name).numpy(),
                                      np.asarray(getattr(js.arena, name)))

    # keyframe insertion, local BA and hygiene, as track() runs them
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
    assert ts.last_kf_id == js.last_kf_id == 2
    a_j, a_t = jfields(js.arena), convert.arena_to_numpy(ts.arena)
    for name in ("n_frames", "n_points", "n_obs", "obs_frame", "obs_point",
                 "obs_kp", "obs_valid", "point_valid", "point_desc",
                 "point_ref_frame", "frame_valid", "frame_desc",
                 "frame_kp_count"):
        np.testing.assert_array_equal(a_t[name], a_j[name], err_msg=name)
    np.testing.assert_allclose(a_t["frame_pose"], a_j["frame_pose"],
                               atol=1e-4)
    np.testing.assert_allclose(a_t["point_xyz"], a_j["point_xyz"],
                               atol=1e-3)
    np.testing.assert_allclose(ts.pose_wc.numpy(), np.asarray(js.pose_wc),
                               atol=1e-4)
    assert np.abs(a_t["frame_pose"][1] - a_t["frame_pose"][0]).max() > 0


def run(slam, frames):
    gts, ts = [], []
    for fr in frames:
        slam.track(fr)
        gts.append(fr.gt_pose[:3])
        ts.append(fr.timestamp)
    return np.asarray(ts), np.stack(gts)


def test_whole_slice_ate_against_reference():
    dj, dt = datasets()
    js = JSLAM(dj.camera, JConfig(**CFG))
    t, gt = run(js, dj)
    ate_j = j_eval(t, js.positions(), t, gt, with_scale=False).ate_rmse
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**CFG), device="cpu")
    t, gt = run(ts, dt)
    m = evaluate_trajectory(t, ts.positions(), t, gt, with_scale=False)
    assert m.n_matched == SMALL["n_frames"]
    assert m.ate_rmse < 0.05
    assert abs(m.ate_rmse - ate_j) <= 0.01
    assert min(s["n_inliers"] for s in ts.stats[1:]) >= 20
    assert len(ts.corrected_positions()) == SMALL["n_frames"]
    np.testing.assert_allclose(ts.corrected_positions(), ts.positions(),
                               atol=1e-4)


def test_whole_slice_with_local_ba():
    """Keyframes every 4 frames, so local BA and the kernel routes run
    inside the loop (plain versions on the CPU)."""
    cfg = dict(CFG, kf_min_gap=2, kf_max_gap=4)
    _, dt = datasets(n_frames=16)
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**cfg), device="cpu")
    t, gt = run(ts, dt)
    m = evaluate_trajectory(t, ts.positions(), t, gt, with_scale=False)
    assert ts._n_frames_host >= 4 and "slam/local_ba" in ts.timer.stats()
    assert m.ate_rmse < 0.05
    assert int(ts.arena.n_frames) == ts._n_frames_host


def test_keyframe_store_full():
    """More keyframes than ``cap_frames``: both packages drop the extra
    keyframe insertions, raise the overflow flag and keep tracking, to
    the whole-slice test's ATE tolerances."""
    cfg = dict(CFG, cap_frames=3, kf_min_gap=1, kf_max_gap=3)
    dj, dt = datasets(n_frames=10)
    js = JSLAM(dj.camera, JConfig(**cfg))
    t, gt = run(js, dj)
    ate_j = j_eval(t, js.positions(), t, gt, with_scale=False).ate_rmse
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**cfg), device="cpu")
    t, gt = run(ts, dt)
    ate_t = evaluate_trajectory(t, ts.positions(), t, gt,
                                with_scale=False).ate_rmse
    assert ts._n_frames_host == js._n_frames_host == 3
    assert bool(ts.arena.overflow) and bool(js.arena.overflow)
    assert int(ts.arena.n_frames) == 3
    assert min(s["n_inliers"] for s in ts.stats[1:]) >= 20
    assert ate_t < 0.05 and abs(ate_t - ate_j) <= 0.01


@pytest.mark.parametrize("what", ["mono", "imu", "vocabulary", "pyramid",
                                  "batch"])
def test_unported_paths_raise(what):
    """What is not ported raises and names its ROADMAP item.  A
    vocabulary is accepted now; behind it the IMU rotation edges of the
    loop pose graph are what still raises."""
    _, dt = datasets(n_frames=2)
    fr = next(iter(dt))
    cfg = dict(CFG)
    kw = {}
    if what == "pyramid":
        cfg["n_levels"] = 2
    elif what == "batch":
        cfg["dispatch_batch"] = 4
    elif what == "vocabulary":
        kw["vocabulary"] = convert.vocabulary_from_numpy(
            np.zeros((3, 8), np.uint32), np.ones(2, np.float32), 2, 1,
            device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        slam = KeyframeSLAM(dt.camera, SLAMConfig(**cfg), device="cpu",
                            **kw)
        if what == "mono":
            fr.depth = None
        elif what == "imu":
            fr.imu = np.zeros((5, 7), np.float32)
        elif what == "vocabulary":
            slam.loop_closer.close(
                slam.arena, dt.camera, 0,
                imu_edges=[(0, 1, np.asarray([1.0, 0, 0, 0], np.float32))])
        slam.track(fr)


def test_wide_ba_window_with_kernels_raises():
    """More cameras than the Schur kernel takes no longer raises when
    the system is built: such a window runs the plain Schur path by the
    rule of shape, as in the JAX package (the 40-camera solve is held
    against it in test_torch_ba.py); the kernel wrapper itself still
    refuses what is beyond its contract."""
    from gslam_tpu_torch.ops.cuda import schur
    from gslam_tpu_torch.opt.ba import resolve_ba_kernels

    _, dt = datasets(n_frames=1)
    cfg = dict(CFG, ba_window=33, cap_frames=64)
    for use_kernels in (True, False):
        slam = KeyframeSLAM(dt.camera,
                            SLAMConfig(**cfg, use_kernels=use_kernels),
                            device="cpu")
        assert slam.cfg.ba_window == 33
    assert not resolve_ba_kernels(True, 33) and resolve_ba_kernels(True, 32)
    with pytest.raises(ValueError, match="cameras"):
        schur._inputs(type("P", (), dict(
            cam_pose=torch.zeros((33, 7)), obs_cam=torch.zeros((4, 2))))())


def test_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, dt = datasets(n_frames=1)
    with pytest.raises(RuntimeError, match="cuda"):
        KeyframeSLAM(dt.camera, SLAMConfig(**CFG))


def reference_ate_full_width(n_frames: int = 64) -> dict:
    """The JAX package's KeyframeSLAM over the first ``n_frames`` frames
    of chip_smoke.py's full-width sequence and configuration (480 x 640
    ring_out, bench.py:136-145, one frame per call): the reference ATE
    that chip_smoke.py's gate is built from.  Runs on the CPU in about
    a minute and a half."""
    seq = dict(n_frames=192, n_points=1200, width=640, height=480,
               motion="ring_out", depth=True, texture=True, radius=14.0,
               world_extent=8.0, laps=1, noise=0.01)
    cfg = dict(max_kps=512, fast_threshold=0.08, local_map_size=2048,
               ba_points=1024, ba_window=8, ba_iters=6, ba_obs_per_point=8,
               kf_max_gap=8, cap_frames=64, cap_points=16384, cap_obs=65536,
               dispatch_batch=1)
    ds = JData(**seq)
    ds.open("synth://")
    frames = [ds.grab_frame() for _ in range(n_frames)]
    js = JSLAM(ds.camera, JConfig(**cfg))
    t, gt = run(js, frames)
    m = j_eval(t, js.positions(), t, gt, with_scale=False)
    return dict(frames=n_frames, ate_m=m.ate_rmse, rpe_m=m.rpe_rmse,
                keyframes=js._n_frames_host,
                tracked=sum(s["n_inliers"] >= js.cfg.min_track_inliers
                            for s in js.stats))


if __name__ == "__main__":
    import json
    import sys

    if sys.argv[1:] != ["--reference-ate"]:
        sys.exit("usage: python tests/test_torch_slam.py --reference-ate")
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    print(json.dumps(reference_ate_full_width()))
