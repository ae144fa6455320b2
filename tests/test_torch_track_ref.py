"""Tracking against the reference keyframe where the motion model misses
(``KeyframeSLAM._track_reference``), on the CPU.

* KITTI 00's stereo geometry at half scale (620x188, fx = fy = 359.428,
  baseline 0.5372 m) in the benchmark's own synthetic world
  (``slambench.scene.World``) with the distances halved too
  (``world_extent`` 4.0), so that a step of 0.82 m moves the image by the
  55-98 px of the full-size cell.  The constant-velocity prediction
  starts at rest, so frame 1's projection misses the 15 px gate: with the
  path taken out, every frame after the first is lost; with it, frame 1
  is tracked through the path and no frame of the 8 is lost.
* At 0.02 m a frame the motion model tracks every frame: the path never
  runs, and the poses are those of a run with the path taken out, bit
  for bit.
* A frame after a BoW relocalization (which resets the velocity to rest)
  takes the path when the motion model misses it.
* The counters ``slam/track_ref/accepted``, ``slam/stereo/keypoints``
  and ``slam/stereo/depths`` observe one call a path and one frame a
  stereo pair.

This file imports neither JAX nor the JAX package: the path is the
port's own (the JAX package coasts where it runs; ROADMAP.md,
"Documented divergences").
"""

import numpy as np
import pytest
import torch

import gslam_tpu_torch.models  # noqa: F401  (registers the systems)
from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM
from gslam_tpu_torch.ops.frontend import extract_features
from gslam_tpu_torch.ops.vocab import train_vocabulary
from slambench.reference import camera_to_world
from slambench.run import make_frames
from slambench.scene import World

torch.set_num_threads(2)

SENSOR = dict(width=620, height=188, rate_hz=10, fx=359.428, fy=359.428,
              cx=303.6, cy=92.6, baseline=0.5372)
# the benchmark configuration's settings (slambench/configs/kitti00_stereo
# .json), its tracking gate and inlier floor among them, at 384 keypoints
CFG = dict(max_kps=384, fast_threshold=0.08, local_map_size=1024,
           ba_points=512, ba_window=8, ba_iters=6, ba_obs_per_point=8,
           kf_max_gap=8, cap_frames=64, cap_points=8192, cap_obs=32768,
           dispatch_batch=1, gate_radius_px=15.0, min_track_inliers=30)
# frame 1's camera centre against the truth: a fifth of the 0.82 m step,
# room for the stereo depths' error (a disparity 0.7 px off at 4 m is 8 cm)
POSE_TOL_M = 0.15


def scene(step, n_frames, **over):
    return dict(scene_seed=3, lap_frames=n_frames, motion="line", step=step,
                n_points=1500, n_texture=5000, world_extent=4.0, dot_half=1,
                noise=0.01, exposure=0.0, depth=False, stereo=True, **over)


def episode(step, n_frames, seed=5):
    sc = scene(step, n_frames)
    ep = World(sc, SENSOR, "cpu").episode(n_frames, seed)
    return sc, make_frames(dict(sensor=SENSOR, scene=sc), ep)


def stereo(frames, seed=5, **over):
    return SLAMS.create("stereo", frames[0].camera, device="cpu",
                        **dict(CFG, seed=seed, **over))


def run(slam, frames):
    return torch.stack([slam.track(fr) for fr in frames]).numpy()


def lost(slam):
    return [i for i, st in enumerate(slam.stats[1:], 1)
            if st["n_inliers"] < slam.cfg.min_track_inliers]


def without_path(monkeypatch):
    monkeypatch.setattr(KeyframeSLAM, "_track_reference",
                        lambda self, feats: None)


@pytest.fixture(scope="module")
def kitti_half():
    return episode(0.82, 8)


def test_frame_one_is_tracked_through_the_path(kitti_half):
    sc, frames = kitti_half
    slam = stereo(frames)
    poses = run(slam, frames)
    st = slam.timer.stats()
    # the path ran once, on frame 1, and was accepted there
    assert st["slam/track_ref"]["count"] == 1
    assert st["slam/track_ref/accepted"]["total"] == 1
    assert slam.stats[1]["n_inliers"] >= slam.cfg.min_track_inliers
    assert lost(slam) == []
    _, t1 = camera_to_world(sc, 1)
    assert np.linalg.norm(poses[1, :3] - t1) < POSE_TOL_M, poses[1]
    assert np.isfinite(poses).all()


def test_the_motion_model_alone_loses_the_case(kitti_half, monkeypatch):
    """The case is one the present motion model loses: frame 1's
    prediction at rest misses, and every later frame with it."""
    _, frames = kitti_half
    without_path(monkeypatch)
    slam = stereo(frames)
    run(slam, frames)
    assert lost(slam) == list(range(1, len(frames)))
    assert "slam/track_ref" not in slam.timer.stats()


def test_slow_motion_never_takes_the_path(monkeypatch):
    _, frames = episode(0.02, 8)
    slam = stereo(frames)
    poses = run(slam, frames)
    st = slam.timer.stats()
    assert "slam/track_ref" not in st and lost(slam) == []
    without_path(monkeypatch)
    plain = stereo(frames)
    assert np.array_equal(run(plain, frames), poses)
    assert [s["n_inliers"] for s in plain.stats] == \
        [s["n_inliers"] for s in slam.stats]


def test_a_frame_after_relocalization_takes_the_path():
    """Map 24 frames, then hand in frame 2's view again at a bogus pose
    with the motion model at rest: the reference keyframe (near frame 23)
    and its covisible keyframes do not see it, BoW relocalization places
    it; frame 3 then misses under the reset velocity and is tracked
    through the path."""
    sc, frames = episode(0.82, 24, seed=6)
    descs = torch.cat([extract_features(
        torch.as_tensor(fr.image), max_kps=CFG["max_kps"],
        threshold=CFG["fast_threshold"]).desc for fr in frames[::3]])
    voc = train_vocabulary(descs, k=6, L=2, seed=0, device="cpu")
    slam = stereo(frames, seed=6, vocabulary=voc)
    run(slam, frames)
    assert lost(slam) == []
    slam.pose_wc = torch.tensor([50.0, 50.0, 50.0, 1.0, 0.0, 0.0, 0.0])
    slam.velocity = slam._identity()
    before = slam.timer.stats()["slam/track_ref/accepted"]
    slam.track(frames[2])
    after = slam.timer.stats()["slam/track_ref/accepted"]
    # the path ran on the kidnapped frame and was refused there; BoW
    # relocalization placed it
    assert after["count"] == before["count"] + 1
    assert after["total"] == before["total"]
    _, t2 = camera_to_world(sc, 2)
    assert np.linalg.norm(slam.pose_wc[:3].numpy() - t2) < 1.0
    assert torch.equal(slam.velocity, slam._identity())
    slam.track(frames[3])
    final = slam.timer.stats()["slam/track_ref/accepted"]
    assert final["count"] == after["count"] + 1
    assert final["total"] == after["total"] + 1
    assert slam.stats[-1]["n_inliers"] >= slam.cfg.min_track_inliers
    _, t3 = camera_to_world(sc, 3)
    assert np.linalg.norm(slam.pose_wc[:3].numpy() - t3) < POSE_TOL_M


def test_counters(kitti_half):
    _, frames = kitti_half
    slam = stereo(frames)
    run(slam, frames)
    st = slam.timer.stats()
    for name in ("slam/track_ref/accepted", "slam/stereo/keypoints",
                 "slam/stereo/depths"):
        assert st[name]["kind"] == "counter", name
    assert st["slam/track_ref/accepted"]["count"] == \
        st["slam/track_ref"]["count"] == 1
    n = len(frames)
    # the motion model's pass counts every frame after the first once; the
    # path's pass against the local map has names of its own
    for name in ("slam/track_fused", "slam/track_fused/matches",
                 "slam/track_fused/inliers", "slam/track_fused/pnp_graph"):
        assert st[name]["count"] == n - 1, name
    for name in ("slam/track_ref/local_map", "slam/track_ref/local_map/pnp",
                 "slam/track_ref/local_map/matches",
                 "slam/track_ref/local_map/inliers",
                 "slam/track_ref/local_map/pnp_graph"):
        assert st[name]["count"] == 1, name
    kps, deps = st["slam/stereo/keypoints"], st["slam/stereo/depths"]
    assert kps["count"] == deps["count"] == st["slam/stereo"]["count"] == n
    assert kps["total"] == n * CFG["max_kps"]
    assert 0.5 * kps["total"] < deps["total"] <= kps["total"]
