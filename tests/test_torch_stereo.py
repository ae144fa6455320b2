"""The port's stereo matching (gslam_tpu_torch.ops.stereo) and StereoSLAM
(gslam_tpu_torch.models.stereo) against the JAX package's, on the
192 x 144 sequences of tests/test_slam_e2e.py:195-259.

* ``match_stereo`` and ``stereo_depth`` are bit for bit the JAX
  package's on the same descriptors and keypoints (a rendered stereo
  frame's, extracted by the JAX package).
* The rendered pair of tests/test_slam_e2e.py:196-241 through the port's
  own extraction: at least 30 matches, median relative depth error under
  0.08 against the rendered depth.
* StereoSLAM over 12 depth-free stereo frames (baseline 0.3 m, 400
  points): ATE under 0.12 m and more than 50 valid map points (the JAX
  test's gates), and within ``2 ref + 0.01`` of the JAX package's run.
* The stereo depths also reach keyframes that ``track_batch`` takes at
  a trigger frame (``dispatch_batch`` 4), where the JAX package calls
  its ``_kp_depths`` hook and the port ``_set_keypoint_samples``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.datasets.synthetic import SyntheticDataset as JData
from gslam_tpu.eval import evaluate_trajectory as j_eval
from gslam_tpu.models.keyframe_slam import SLAMConfig as JConfig
from gslam_tpu.models.stereo import StereoSLAM as JStereo
from gslam_tpu.ops.frontend import extract_features as j_extract
from gslam_tpu.ops.stereo import match_stereo as j_match_stereo
from gslam_tpu.ops.stereo import stereo_depth as j_stereo_depth
from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.map.arena import arena_stats
from gslam_tpu_torch.models.keyframe_slam import SLAMConfig
from gslam_tpu_torch.models.stereo import StereoSLAM
from gslam_tpu_torch.ops.frontend import extract_features
from gslam_tpu_torch.ops.stereo import match_stereo, stereo_depth
from tests.test_torch_slam import CFG, SMALL, port_features, run

torch.set_num_threads(2)

STEREO = dict(SMALL, depth=False, stereo=True, baseline=0.3, n_points=400)


def datasets(**over):
    a, b = JData(**{**STEREO, **over}), SyntheticDataset(**{**STEREO, **over})
    a.open("synth://")
    b.open("synth://")
    return a, b


@pytest.mark.parametrize("frame", [0, 7])
def test_match_stereo_and_depth_bit_for_bit(frame):
    dj, _ = datasets(n_frames=frame + 1)
    fr = list(dj)[frame]
    fl = j_extract(jnp.asarray(fr.image), max_kps=192, threshold=0.1)
    frr = j_extract(jnp.asarray(fr.image_right), max_kps=192, threshold=0.1)
    disp_j, ok_j = j_match_stereo(fl.desc, fl.valid, fl.uv, frr.desc,
                                  frr.valid, frr.uv, max_disparity=128.0)
    depth_j = j_stereo_depth(disp_j, ok_j, dj.camera.fx, fr.stereo_baseline)
    tl, tr = port_features(fl), port_features(frr)
    disp_t, ok_t = match_stereo(tl.desc, tl.valid, tl.uv, tr.desc, tr.valid,
                                tr.uv, max_disparity=128.0)
    depth_t = stereo_depth(disp_t, ok_t, dj.camera.fx, fr.stereo_baseline)
    assert int(ok_t.sum()) >= 30
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(disp_t.numpy(), np.asarray(disp_j))
    np.testing.assert_array_equal(depth_t.numpy(), np.asarray(depth_j))


def test_stereo_depth_from_rendered_pair():
    """tests/test_slam_e2e.py:196-241: the right view rendered from a
    camera shifted by the baseline, depth against the rendered depth."""
    ds = SyntheticDataset(**dict(SMALL, n_points=400))
    ds.open("synth://")
    fr = ds.grab_frame()
    baseline = 0.2
    cam = ds.camera
    img_r = np.zeros_like(fr.image)
    pc = ds.X - np.array([baseline, 0.0, 0.0])
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    ui, vi = np.round(u).astype(int), np.round(v).astype(int)
    ok = (pc[:, 2] > 0.5) & (ui >= 2) & (ui < img_r.shape[1] - 2) \
        & (vi >= 2) & (vi < img_r.shape[0] - 2)
    img_r += 0.08 + 0.04 * np.linspace(0, 1, img_r.shape[1])[None, :]
    for j in np.nonzero(ok)[0]:
        img_r[vi[j] - 1:vi[j] + 2, ui[j] - 1:ui[j] + 2] = ds.I[j]
    fl = extract_features(torch.as_tensor(fr.image), max_kps=192,
                          threshold=0.1)
    frt = extract_features(torch.as_tensor(img_r.astype(np.float32)),
                           max_kps=192, threshold=0.1)
    disp, ok_m = match_stereo(fl.desc, fl.valid, fl.uv, frt.desc, frt.valid,
                              frt.uv)
    depth = stereo_depth(disp, ok_m, cam.fx, baseline).numpy()
    okn = ok_m.numpy()
    assert okn.sum() >= 30
    uv = fl.uv.numpy()[okn].astype(int)
    gt = fr.depth[uv[:, 1], uv[:, 0]]
    good = gt > 0
    rel = np.abs(depth[okn][good] - gt[good]) / gt[good]
    assert np.median(rel) < 0.08


@pytest.fixture(scope="module")
def reference_ate():
    dj, _ = datasets()
    js = JStereo(dj.camera, JConfig(**CFG))
    t, gt = run(js, dj)
    return j_eval(t, js.positions(), t, gt, with_scale=False).ate_rmse


def test_stereo_slam_against_reference(reference_ate):
    _, dt = datasets()
    fr0 = dt.grab_frame()
    assert fr0.image_right is not None and fr0.depth is None
    dt.open("synth://")
    slam = SLAMS.create("stereo", dt.camera, device="cpu", **CFG)
    assert isinstance(slam, StereoSLAM)
    t, gt = run(slam, dt)
    m = evaluate_trajectory(t, slam.positions(), t, gt, with_scale=False)
    assert m.n_matched == SMALL["n_frames"]
    assert m.ate_rmse < 0.12
    assert m.ate_rmse <= 2.0 * reference_ate + 0.01
    assert arena_stats(slam.arena)["valid_points"] > 50
    assert slam.timer.stats()["slam/stereo"]["count"] == SMALL["n_frames"]


def test_stereo_depths_reach_trigger_frames_of_track_batch():
    """With 4 frames a dispatch and a keyframe at least every 4 frames,
    keyframes are taken at trigger frames; each gets its points from
    stereo depth."""
    _, dt = datasets()
    frames = list(dt)
    slam = StereoSLAM(dt.camera, SLAMConfig(**dict(CFG, kf_min_gap=2,
                                                 kf_max_gap=4,
                                                 dispatch_batch=4)),
                      device="cpu")
    sequential = []
    track = slam.track

    def counted_track(fr):
        sequential.append(fr.id)
        return track(fr)

    slam.track = counted_track
    kf_points = []
    insert = slam._insert_keyframe

    def recorded_insert(frame, feats, pose_cw, **kw):
        kf_points.append(int(torch.isfinite(slam._cur_kp_depth).sum()
                             if slam._cur_kp_depth is not None else -1))
        return insert(frame, feats, pose_cw, **kw)

    slam._insert_keyframe = recorded_insert
    poses = slam.track_batch(frames)
    assert len(poses) == len(frames)
    n_stereo = slam.timer.stats()["slam/stereo"]["count"]
    n_triggers = sum(a < 4 for a in slam.batch_accepted)
    assert n_triggers >= 1 and len(sequential) < len(frames)
    assert n_stereo == len(sequential) + n_triggers
    assert slam._n_frames_host >= 2
    assert all(n > 0 for n in kf_points)
    t = np.asarray([fr.timestamp for fr in frames])
    gt = np.stack([fr.gt_pose[:3] for fr in frames])
    m = evaluate_trajectory(t, slam.positions(), t, gt, with_scale=False)
    assert m.ate_rmse < 0.12
