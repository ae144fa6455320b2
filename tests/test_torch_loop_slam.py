"""The loop-closure slice as a whole: the port's KeyframeSLAM with a
vocabulary against the JAX package's, on the ring with a revisit of
tests/test_loop_closure.py (192x144, 58 frames, vocabulary k=6, L=2,
stock loop-closer settings), and the kidnapped-camera recovery of that
file's TestRelocalization in the port.

Both packages get one vocabulary (trained by the port; test_torch_vocab
holds the two trainers equal).  Gates: each run closes at least one loop
and keeps the ATE under that test's 2.0 m, and the two ATEs lie within
1.5 m of each other.  That distance is the instrument's own spread, not
the port's: tracking on this ring runs at 6 to 15 inliers a frame, so
the result hangs on the RANSAC draws, which the two packages cannot
share (over four seeds the JAX package's ATE is 0.71 to 1.74 m, over six
the port's 0.87 to 3.03 m: ``python tests/test_torch_loop_slam.py
--seed-spread`` prints them).  The port's draws are seeded with 4, the JAX
package's with its default.  What the two do share is held exactly in
test_torch_loop_closure.py, draw for draw.  The corrected trajectory is
compared on the JAX run's own state carried into the port, to 1e-5.
"""

import numpy as np
import pytest
import torch

from gslam_tpu.eval import evaluate_trajectory as j_eval
from gslam_tpu.models.keyframe_slam import KeyframeSLAM as JSLAM
from gslam_tpu.models.keyframe_slam import SLAMConfig as JConfig
from gslam_tpu_torch import convert
from gslam_tpu_torch.core.se3 import se3_inverse
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.map.arena import save_arena
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.models.loop_closure import LoopCloser
from gslam_tpu_torch.ops.frontend import extract_features
from tests.test_loop_closure import _ring_frames as j_ring_frames
from tests.test_torch_arena import jfields
from tests.test_torch_loop_closure import CFG, ring_frames, ring_vocabulary

torch.set_num_threads(2)

PORT_SEED = 4
ATE_GATE = 2.0          # tests/test_loop_closure.py::test_ring_provably_closes
ATE_APART = 1.5


@pytest.fixture(scope="module")
def voc():
    return ring_vocabulary()


def run(slam, frames):
    gts, ts = [], []
    for fr in frames:
        slam.track(fr)
        gts.append(fr.gt_pose[:3])
        ts.append(fr.timestamp)
    return np.asarray(ts), np.stack(gts)


def port_slam(camera, voc_t, **over):
    return KeyframeSLAM(camera, SLAMConfig(**{**CFG, **over}),
                        vocabulary=voc_t, device="cpu")


def test_ring_closes_in_both_packages(voc):
    voc_t, voc_j = voc
    frames = ring_frames(48, revisit=10)
    frames_j = j_ring_frames(48, revisit=10)
    js = JSLAM(frames_j[0].camera, JConfig(**CFG), vocabulary=voc_j)
    t, gt = run(js, frames_j)
    ate_j = j_eval(t, js.positions(), t, gt, with_scale=False).ate_rmse
    ts = port_slam(frames[0].camera, voc_t, seed=PORT_SEED)
    run(ts, frames)
    m = evaluate_trajectory(t, ts.positions(), t, gt, with_scale=False)
    mc = evaluate_trajectory(t, ts.corrected_positions(), t, gt,
                             with_scale=False)
    assert isinstance(ts.loop_closer, LoopCloser)
    for closer in (ts.loop_closer, js.loop_closer):
        assert closer.n_kf >= 5 and len(closer.closed) >= 1
    assert ts.loop_closer.min_inliers == js.loop_closer.min_inliers == 12
    assert ts.loop_closer.min_gap == js.loop_closer.min_gap == 3
    assert m.n_matched == len(frames)
    assert ate_j < ATE_GATE and m.ate_rmse < ATE_GATE
    assert mc.ate_rmse < ATE_GATE
    assert abs(m.ate_rmse - ate_j) <= ATE_APART
    st = ts.timer.stats()
    assert st["slam/loop"]["count"] == ts.loop_closer.n_kf
    assert len(ts.loop_closer.verify_log) >= 3
    # a closure re-bases the frames before it: the corrected trajectory
    # differs from the tracked one, and is finite
    corrected = ts.corrected_trajectory()
    assert corrected.shape == (len(frames), 7)
    assert np.isfinite(corrected).all()
    assert np.abs(corrected[:, :3] - ts.positions()).max() > 1e-3

    # corrected_trajectory on the JAX run's state, carried across
    carried = KeyframeSLAM(frames[0].camera, SLAMConfig(**CFG),
                           device="cpu")
    carried.arena = convert.arena_from_numpy(jfields(js.arena), "cpu")
    carried._traj_rel = [(int(k), torch.tensor(np.asarray(r, np.float32)))
                         for k, r in js._traj_rel]
    ref = js.corrected_trajectory()
    np.testing.assert_allclose(carried.corrected_trajectory(), ref,
                               atol=1e-5)
    np.testing.assert_allclose(carried.corrected_positions(),
                               js.corrected_positions(), atol=1e-5)
    assert np.abs(ref[:, :3] - js.positions()).max() > 1e-3


@pytest.fixture(scope="module")
def mapped_ring(voc):
    frames = ring_frames(48)
    slam = port_slam(frames[0].camera, voc[0])
    run(slam, frames)
    return slam, frames


def test_kidnapped_recovery(mapped_ring):
    """After mapping the ring, the tracker is teleported to a bogus
    pose with a dead motion model and fed frames from the far side: BoW
    relocalization brings the pose back to where the map holds that
    view, and tracking re-engages (the gates of
    tests/test_loop_closure.py::TestRelocalization)."""
    slam, frames = mapped_ring
    slam.pose_wc = torch.tensor([50.0, 50.0, 50.0, 1.0, 0, 0, 0])
    slam.velocity = slam._identity()
    slam._lost_frames = 0
    target = 24
    for t in range(target, target + 5):
        slam.track(frames[t])
        est = slam.pose_wc[:3].numpy()
        if np.linalg.norm(est) < 40.0:       # left the kidnap pose
            break
    F = int(slam.arena.n_frames)
    kf_t = slam.arena.frame_time[:F].numpy()
    kf_ctr = se3_inverse(slam.arena.frame_pose[:F, :7])[:, :3].numpy()
    ref = kf_ctr[np.abs(kf_t - frames[t].timestamp).argmin()]
    assert np.linalg.norm(est - ref) < 3.0, (t - target + 1, est, ref)
    best = 0
    for t2 in range(t + 1, t + 4):
        slam.track(frames[t2])
        best = max(best, slam.stats[-1]["n_inliers"])
    assert best >= slam.cfg.min_track_inliers, best


def test_relocalize_needs_a_database(voc):
    """No vocabulary, or fewer than two keyframes: nothing to query."""
    frames = ring_frames(2)
    feats = extract_features(torch.as_tensor(frames[1].image),
                             max_kps=CFG["max_kps"],
                             threshold=CFG["fast_threshold"])
    no_voc = KeyframeSLAM(frames[0].camera, SLAMConfig(**CFG), device="cpu")
    run(no_voc, frames)
    assert no_voc.loop_closer is None and not no_voc._relocalize(feats)
    one_kf = port_slam(frames[0].camera, voc[0])
    one_kf.track(frames[0])
    assert one_kf.loop_closer.n_kf == 1 and not one_kf._relocalize(feats)


def test_load_map_rebuilds_the_database(mapped_ring, voc, tmp_path):
    """A saved map loads into a fresh system, whose BoW database is
    rebuilt from the stored descriptors; tracking resumes on it."""
    slam, frames = mapped_ring
    path = str(tmp_path / "ring_map.npz")
    save_arena(slam.arena, path)
    fresh = port_slam(frames[0].camera, voc[0])
    fresh.load_map(path)
    F = int(slam.arena.n_frames)
    assert fresh.initialized and fresh.last_kf_id == F - 1
    assert fresh.loop_closer.n_kf == slam.loop_closer.n_kf == F
    assert torch.equal(fresh.loop_closer.bow_words[:F],
                       slam.loop_closer.bow_words[:F])
    assert torch.equal(fresh.loop_closer.bow_weights[:F],
                       slam.loop_closer.bow_weights[:F])
    np.testing.assert_allclose(
        fresh.pose_wc.numpy(),
        se3_inverse(slam.arena.frame_pose[F - 1, :7]).numpy(), atol=1e-6)
    # from an arena, at a given pose
    again = port_slam(frames[0].camera, voc[0])
    again.load_map(slam.arena, pose_wc=np.asarray([1, 2, 3, 1, 0, 0, 0.0]))
    assert again.pose_wc.tolist() == [1, 2, 3, 1, 0, 0, 0]


def test_vocabulary_on_another_device_is_refused(voc):
    class Elsewhere:
        device = torch.device("meta")

    frames = ring_frames(1)
    with pytest.raises(ValueError, match="vocabulary lies on"):
        KeyframeSLAM(frames[0].camera, SLAMConfig(**CFG),
                     vocabulary=Elsewhere(), device="cpu")


def seed_spread(jax_seeds=range(4), port_seeds=range(6)) -> dict:
    """ATE (m) and closures of the ring with a revisit over RANSAC seeds,
    in both packages: the spread that ``ATE_APART`` is stated against.
    Runs on the CPU in about eight minutes."""
    voc_t, voc_j = ring_vocabulary()
    frames, frames_j = ring_frames(48, 10), j_ring_frames(48, 10)
    out = {"jax": {}, "port": {}}
    for seed in jax_seeds:
        js = JSLAM(frames_j[0].camera, JConfig(**CFG, seed=seed),
                   vocabulary=voc_j)
        t, gt = run(js, frames_j)
        out["jax"][seed] = dict(
            ate_m=float(j_eval(t, js.positions(), t, gt,
                               with_scale=False).ate_rmse),
            closed=js.loop_closer.closed)
    for seed in port_seeds:
        ts = port_slam(frames[0].camera, voc_t, seed=seed)
        t, gt = run(ts, frames)
        out["port"][seed] = dict(
            ate_m=float(evaluate_trajectory(t, ts.positions(), t, gt,
                                            with_scale=False).ate_rmse),
            closed=ts.loop_closer.closed)
    return out


if __name__ == "__main__":
    import json
    import sys

    import jax

    if sys.argv[1:] != ["--seed-spread"]:
        sys.exit("usage: python tests/test_torch_loop_slam.py --seed-spread")
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    print(json.dumps(seed_spread()))
