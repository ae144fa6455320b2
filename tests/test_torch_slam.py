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
* A BA window wider than the Schur kernel takes runs the plain path.

Pyramid extraction and the visual-inertial mode are held in
test_torch_pyramid.py and test_torch_vi_slam.py.
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


FULL_SEQUENCE = dict(n_frames=192, n_points=1200, width=640, height=480,
                     motion="ring_out", depth=True, texture=True, radius=14.0,
                     world_extent=8.0, laps=1, noise=0.01)
FULL_CFG = dict(max_kps=512, fast_threshold=0.08, local_map_size=2048,
                ba_points=1024, ba_window=8, ba_iters=6, ba_obs_per_point=8,
                kf_max_gap=8, cap_frames=64, cap_points=16384, cap_obs=65536,
                dispatch_batch=1)
# chip_smoke.py's monocular run: 48 depth-free frames of the line motion
# over 3000 untextured points
MONO_SEQUENCE = dict(n_frames=48, n_points=3000, width=640, height=480,
                     motion="line", depth=False, texture=False, noise=0.01)
# the JAX package's RANSAC draws of that run, for replay in the port
MONO_DRAWS = "tests/data/mono_draws.npz"
# chip_smoke.py's pyramid run: the 64-frame cell with three levels
PYRAMID_CFG = dict(FULL_CFG, n_levels=3, pyramid_scale=1.25)
# chip_smoke.py's visual-inertial run: 64 frames of the line motion with
# IMU windows, the VI settings of tests/test_slam_e2e.py:465-466
VI_SEQUENCE = dict(n_frames=64, n_points=1200, width=640, height=480,
                   motion="line", depth=True, texture=True, imu=True,
                   noise=0.01)
VI_CFG = dict(FULL_CFG, vi_min_factors=6, kf_min_gap=2, kf_max_gap=6)


# chip_smoke.py's distorted run: the hard synthetic gate of
# tests/test_slam_e2e.py:527-549 at full width, and its TUM-layout run
# (64 frames of the same scene written to disk and read back)
DISTORTED_SEQUENCE = dict(n_frames=40, n_points=600, width=640, height=480,
                          motion="line", depth=True, texture=True,
                          exposure=0.15, distortion=[-0.25, 0.08])
DISTORTED_CFG = dict(max_kps=384, fast_threshold=0.08, ba_window=4,
                     ba_points=512, ba_iters=3, cap_frames=32,
                     cap_points=8192, cap_obs=32768, local_map_size=768,
                     kf_max_gap=6)
TUM_SEQUENCE = dict(DISTORTED_SEQUENCE, n_frames=64)


def reference_run(seq: dict, cfg: dict, n_frames: int, batched: bool,
                  with_scale: bool) -> dict:
    """The JAX package's KeyframeSLAM over the first ``n_frames`` frames
    of ``seq`` under ``cfg``, one frame a ``track`` call or through
    ``track_batch``: ATE (with scale alignment for depth-free runs), RPE,
    keyframes, tracked frames and the first frame with a map."""
    ds = JData(**seq)
    ds.open("synth://")
    frames = [ds.grab_frame() for _ in range(n_frames)]
    js = JSLAM(ds.camera, JConfig(**cfg))
    if batched:
        js.track_batch(frames)
    else:
        run(js, frames)
    t = np.asarray([fr.timestamp for fr in frames])
    gt = np.stack([fr.gt_pose[:3] for fr in frames])
    m = j_eval(t, js.positions(), t, gt, with_scale=with_scale)
    out = dict(frames=n_frames, ate_m=m.ate_rmse, rpe_m=m.rpe_rmse,
               keyframes=js._n_frames_host,
               tracked=sum(s["n_inliers"] >= js.cfg.min_track_inliers
                           for s in js.stats),
               first_mapped=next((i for i, s in enumerate(js.stats)
                                  if s["n_kf"] > 0), None))
    if seq.get("imu"):
        out.update(vi_ready=js.vi_ready, imu_factors=len(js.imu_factors),
                   imu_edges=len(js.imu_edges),
                   gravity_w=None if js.gravity_w is None
                   else np.asarray(js.gravity_w).tolist())
    return out


def reference_tum_run(n_frames: int = 64) -> dict:
    """The JAX package's KeyframeSLAM over chip_smoke.py's TUM-layout
    files: the port's synthetic frames written by chip_smoke's own writer
    into a temporary directory, read back through the JAX package's
    open_dataset (its PIL decode), DISTORTED_CFG; ATE, keyframes,
    tracked frames."""
    import tempfile

    from chip_smoke import write_tum_sequence
    from gslam_tpu.app.registry import open_dataset as j_open

    src = SyntheticDataset(**dict(TUM_SEQUENCE, n_frames=n_frames))
    src.open("synth://")
    with tempfile.TemporaryDirectory() as tmp:
        root = tmp + "/synth_distorted"
        write_tum_sequence(root, list(src), src.camera)
        ds = j_open(root + ".tumrgbd")
        frames = list(ds)
    js = JSLAM(ds.camera, JConfig(**DISTORTED_CFG))
    t, gt = run(js, frames)
    m = j_eval(t, js.positions(), t, gt, with_scale=False)
    return dict(frames=n_frames, camera=ds.camera.model, ate_m=m.ate_rmse,
                rpe_m=m.rpe_rmse, keyframes=js._n_frames_host,
                tracked=sum(s["n_inliers"] >= js.cfg.min_track_inliers
                            for s in js.stats))


def record_mono_draws(path: str = MONO_DRAWS) -> dict:
    """The JAX package's run of ``--reference-ate-mono`` with its RANSAC
    draws recorded, in the order the run takes them, into ``path``:
    ``kind`` (0 a tracked frame's (256, 4) PnP draw, 1 the two-view
    bootstrap's pair), ``pnp`` (n, 256, 4), ``two_view_e`` (m, 256, 8)
    and ``two_view_h`` (m, 256, 4) (the halves of the key the bootstrap
    splits), and the run's inlier count per frame."""
    ds = JData(**MONO_SEQUENCE)
    ds.open("synth://")
    js = JSLAM(ds.camera, JConfig(**FULL_CFG))
    drawn = []
    next_key = js._next_key

    def recorded_key():
        drawn.append((js.initialized, next_key()))
        return drawn[-1][1]

    js._next_key = recorded_key
    t, gt = run(js, ds)
    pairs = [jax.random.split(k) for had_map, k in drawn if not had_map]

    def uniforms(keys, k):
        return np.asarray([jax.random.uniform(key, (256, k)) for key in keys],
                          np.float32)

    np.savez_compressed(
        path, kind=np.asarray([0 if m else 1 for m, _ in drawn], np.int8),
        pnp=uniforms([k for m, k in drawn if m], 4),
        two_view_e=uniforms([e for e, _ in pairs], 8),
        two_view_h=uniforms([h for _, h in pairs], 4),
        inliers=np.asarray([s["n_inliers"] for s in js.stats], np.int32))
    m = j_eval(t, js.positions(), t, gt, with_scale=True)
    return dict(path=path, draws=len(drawn), ate_m=m.ate_rmse,
                tracked=sum(s["n_inliers"] >= js.cfg.min_track_inliers
                            for s in js.stats))


def frames_of(seq: dict, n: int, depth: bool = True) -> list:
    """The JAX package's first ``n`` frames of ``seq``, without their
    depth images when ``depth`` is False."""
    import dataclasses

    ds = JData(**seq)
    ds.open("synth://")
    frames = [ds.grab_frame() for _ in range(n)]
    if not depth:
        frames = [dataclasses.replace(fr, depth=None) for fr in frames]
    return ds.camera, frames


def trajectory_record(system, frames, with_scale: bool, **extra) -> dict:
    t = np.asarray([fr.timestamp for fr in frames])
    gt = np.stack([fr.gt_pose[:3] for fr in frames])
    m = j_eval(t, system.positions(), t, gt, with_scale=with_scale)
    return dict(frames=len(frames), ate_m=m.ate_rmse, rpe_m=m.rpe_rmse,
                **extra)


def reference_odometry(depth: bool, draws_path: str = None) -> dict:
    """The JAX package's FrameToFrameOdometry over chip_smoke.py's 64
    frames (with or without depth): ATE (after Sim3 alignment without
    depth), frames with at least 10 inliers; with ``draws_path``, the
    run's two-view draws in the order it took them (its key chain split
    once per call, each key into E and H halves) written there."""
    from chip_smoke import ODOM_CFG, SLAM_FRAMES
    from gslam_tpu.models.odometry import FrameToFrameOdometry

    cam, frames = frames_of(FULL_SEQUENCE, SLAM_FRAMES, depth)
    odom = FrameToFrameOdometry(cam, **ODOM_CFG)
    keys = []
    next_key = odom._next_key

    def recorded_key():
        keys.append(next_key())
        return keys[-1]

    odom._next_key = recorded_key
    for fr in frames:
        odom.track(fr)
    out = trajectory_record(
        odom, frames, with_scale=not depth, draws=len(keys),
        tracked=sum(s["n_inliers"] >= 10 for s in odom.stats),
        inliers=[s["n_inliers"] for s in odom.stats])
    if draws_path:
        halves = [jax.random.split(k) for k in keys]
        np.savez_compressed(draws_path, two_view_e=np.asarray(
            [jax.random.uniform(e, (256, 8)) for e, _ in halves], np.float32),
            two_view_h=np.asarray([jax.random.uniform(h, (256, 4))
                                   for _, h in halves], np.float32),
            inliers=np.asarray(out["inliers"], np.int32))
        out["path"] = draws_path
    return out


def reference_stereo() -> dict:
    """The JAX package's StereoSLAM over chip_smoke.py's KITTI-shaped
    stereo frames, SLAM_CFG."""
    from chip_smoke import STEREO_SEQUENCE
    from gslam_tpu.models.stereo import StereoSLAM

    cam, frames = frames_of(STEREO_SEQUENCE, STEREO_SEQUENCE["n_frames"])
    js = StereoSLAM(cam, JConfig(**FULL_CFG))
    run(js, frames)
    return trajectory_record(
        js, frames, with_scale=False, keyframes=js._n_frames_host,
        tracked=sum(s["n_inliers"] >= js.cfg.min_track_inliers
                    for s in js.stats),
        valid_points=int(np.asarray(js.arena.point_valid).sum()))


def reference_direct(line: bool) -> dict:
    """The JAX package's DirectOdometry (defaults) over chip_smoke.py's
    64 frames, or 64 frames of its line scene (DIRECT_LINE_SEQUENCE)."""
    from chip_smoke import DIRECT_LINE_SEQUENCE, SLAM_FRAMES
    from gslam_tpu.models.direct import DirectConfig, DirectOdometry

    seq = DIRECT_LINE_SEQUENCE if line else FULL_SEQUENCE
    cam, frames = frames_of(seq, SLAM_FRAMES)
    jd = DirectOdometry(cam, DirectConfig())
    run(jd, frames)
    return trajectory_record(
        jd, frames, with_scale=False,
        tracked=sum(s["n_inliers"] >= 0.25 * jd.cfg.n_points
                    for s in jd.stats))


def reference_sfm(draws_path: str = None, wide: bool = False) -> dict:
    """The JAX package's GlobalSfM over chip_smoke.py's orbit frames (its
    256 x 192 cell, or with ``wide`` its 640 x 480 one): ATE after Sim3
    alignment, edges; with ``draws_path``, its pair draws (per chunk
    ``split(key)`` then ``split(sub, len(chunk))``, each pair's key into
    E and H halves) written there, pair by pair.  The draws depend on
    the seed and the pair count alone, so both cells share them."""
    from chip_smoke import (
        SFM_FRAMES, SFM_KW, SFM_SEQUENCE, SFM_WIDE_KW, SFM_WIDE_SEQUENCE,
    )
    from gslam_tpu.models.sfm import GlobalSfM

    cam, frames = frames_of(SFM_WIDE_SEQUENCE if wide else SFM_SEQUENCE,
                            SFM_FRAMES)
    sfm = GlobalSfM(cam, **(SFM_WIDE_KW if wide else SFM_KW))
    key = sfm.key
    for fr in frames:
        sfm.track(fr)
    res = sfm.finalize()
    out = trajectory_record(sfm, frames, with_scale=True,
                            edges=res["n_edges"])
    if draws_path:
        n_pairs = SFM_FRAMES * (SFM_FRAMES - 1) // 2
        e, h = [], []
        for s in range(0, n_pairs, sfm.pair_chunk):
            key, sub = jax.random.split(key)
            for k in jax.random.split(sub, min(sfm.pair_chunk,
                                               n_pairs - s)):
                ke, kh = jax.random.split(k)
                e.append(jax.random.uniform(ke, (256, 8)))
                h.append(jax.random.uniform(kh, (256, 4)))
        np.savez_compressed(draws_path, two_view_e=np.asarray(e, np.float32),
                            two_view_h=np.asarray(h, np.float32))
        out["path"] = draws_path
    return out


def reference_fleet() -> dict:
    """The JAX package's fleet run: chip_smoke.py's 64 frames of the
    sequence under each of FLEET_SEEDS through KeyframeSLAM, the maps
    merged with FLEET_ALIGN, global BA (FLEET_GBA, every keyframe) over
    a (1, 1) mesh: the keyframe ATE of the merged map (chip_smoke's
    ``fleet_ate``), keyframes and the cost history."""
    from chip_smoke import (
        FLEET_ALIGN, FLEET_GBA, FLEET_SEEDS, SLAM_FRAMES, fleet_ate,
    )
    from gslam_tpu.core.se3 import se3_inverse as j_inv
    from gslam_tpu.map.arena import merge_arenas
    from gslam_tpu.opt.ba import global_bundle_adjust
    from gslam_tpu.parallel.mesh import make_mesh

    runs = []
    for seed in FLEET_SEEDS:
        cam, frames = frames_of(dict(FULL_SEQUENCE, seed=seed), SLAM_FRAMES)
        js = JSLAM(cam, JConfig(**FULL_CFG))
        run(js, frames)
        runs.append((js, frames))
    (a, fa), (b, fb) = runs
    merged = merge_arenas(a.arena, b.arena,
                          transform_b=jnp.asarray(FLEET_ALIGN, jnp.float32))
    n_a, n = a._n_frames_host, a._n_frames_host + b._n_frames_host
    out, costs = global_bundle_adjust(
        merged, cam, max_cams=n,
        mesh=make_mesh((1, 1), devices=jax.devices("cpu")[:1]), **FLEET_GBA)
    centres = np.asarray(j_inv(out.frame_pose[:n, :7])[:, :3])

    def gt(frames):
        return (np.asarray([fr.timestamp for fr in frames]),
                np.stack([fr.gt_pose[:3] for fr in frames]))

    return dict(ate_m=fleet_ate(centres, np.asarray(out.frame_time[:n]), n_a,
                                gt(fa), gt(fb)),
                keyframes=[n_a, n - n_a], costs=np.asarray(costs).tolist())


REFERENCE_RUNS = {
    # chip_smoke.py's 64-frame cell (bench.py:136-145, one frame a call)
    "--reference-ate": lambda: reference_run(
        FULL_SEQUENCE, FULL_CFG, 64, batched=False, with_scale=False),
    # the full-system cell of bench.py:136-151: 192 frames, 8 a dispatch
    "--reference-ate-batched": lambda: reference_run(
        FULL_SEQUENCE, dict(FULL_CFG, dispatch_batch=8), 192, batched=True,
        with_scale=False),
    # the monocular run, ATE after scale alignment
    "--reference-ate-mono": lambda: reference_run(
        MONO_SEQUENCE, FULL_CFG, 48, batched=False, with_scale=True),
    # the same run, its draws written to MONO_DRAWS
    "--reference-draws-mono": record_mono_draws,
    # the 64-frame cell with pyramid extraction
    "--reference-ate-pyramid": lambda: reference_run(
        FULL_SEQUENCE, PYRAMID_CFG, 64, batched=False, with_scale=False),
    # the visual-inertial run
    "--reference-ate-vi": lambda: reference_run(
        VI_SEQUENCE, VI_CFG, 64, batched=False, with_scale=False),
    # the hard synthetic gate at full width, one frame a call and 8 a
    # dispatch
    "--reference-ate-distorted": lambda: reference_run(
        DISTORTED_SEQUENCE, DISTORTED_CFG, 40, batched=False,
        with_scale=False),
    "--reference-ate-distorted-batched": lambda: reference_run(
        DISTORTED_SEQUENCE, dict(DISTORTED_CFG, dispatch_batch=8), 40,
        batched=True, with_scale=False),
    # the same scene through files in the TUM RGB-D layout
    "--reference-ate-tum": reference_tum_run,
    # frame-to-frame odometry over the 64 frames, with depth and without
    "--reference-ate-odometry": lambda: reference_odometry(True),
    "--reference-ate-odometry-mono": lambda: reference_odometry(False),
    # the mono run, its draws written for chip_smoke.py's replay
    "--reference-draws-odometry-mono": lambda: reference_odometry(
        False, "tests/data/odometry_mono_draws.npz"),
    # stereo SLAM on KITTI 00's rectified geometry
    "--reference-ate-stereo": reference_stereo,
    # direct odometry over the 64 frames, and over 64 frames of the line
    # motion (chip_smoke.py's DIRECT_LINE_SEQUENCE)
    "--reference-ate-direct": lambda: reference_direct(False),
    "--reference-ate-direct-line": lambda: reference_direct(True),
    # global SfM over 10 orbit frames at 256 x 192, its draws, and the
    # same frames at 640 x 480
    "--reference-ate-sfm": reference_sfm,
    "--reference-ate-sfm-wide": lambda: reference_sfm(wide=True),
    "--reference-draws-sfm": lambda: reference_sfm(
        "tests/data/sfm_draws.npz"),
    # two sequences merged, then global BA over a (1, 1) mesh
    "--reference-ate-fleet": reference_fleet,
}


if __name__ == "__main__":
    import json
    import sys

    if len(sys.argv) != 2 or sys.argv[1] not in REFERENCE_RUNS:
        sys.exit("usage: python tests/test_torch_slam.py "
                 + " | ".join(REFERENCE_RUNS))
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    print(json.dumps(REFERENCE_RUNS[sys.argv[1]]()))
