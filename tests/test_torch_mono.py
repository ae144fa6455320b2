"""The port's monocular KeyframeSLAM (frames without depth) against the
JAX package's, on the 192 x 144 ``line`` sequence of
tests/test_torch_slam.py without depth.

* The two-view bootstrap in lockstep: both packages take the JAX
  package's features of frames 0 and 1, and the port the JAX package's
  draws (the key ``_initialize`` gives ``two_view_geometry``, split into
  the E and H uniforms).  Match decisions and the model choice are
  equal, the inlier count within 1, and the map the bootstrap writes
  (two keyframes, their points and observation tables) is equal.  At
  the small parallax of two consecutive frames the homography that wins
  decomposes ill-conditioned in float32: T_21 differs by 3.1e-4 between
  the packages (held to 1e-3, and the triangulated points, up to 83 m
  deep at unit baseline, to 1e-3 of their distance), while in float64,
  with the JAX package's float64 draws, T_21 agrees to 1e-9.
* Batched dispatch on the depth-free sequence against the port's own
  sequential run, with the same draws frame by frame: equal poses (to
  1e-6) and keyframes; the trigger frames take the depth-free keyframe
  insertion (triangulation against the previous keyframe).
* The whole 16-frame run through both packages: the map is initialised
  on the same frame, keyframes within 1, and the ATE after scale
  alignment within ``max(0.05, 2 ref + 0.01)`` of the JAX run's.
* The first frames of chip_smoke.py's 480 x 640 depth-free sequence
  with the JAX package's draws of its reference run replayed
  (tests/data/mono_draws.npz, which the chip run's gate replays): the
  port takes the same kinds of draw in the same order, maps on the same
  frame, and tracks with inlier counts within 4 of the JAX run's (the
  same draws give float32 P3P poses within 1e-4, which moves a few
  points across the inlier gate, and that compounds over frames).
* Where the port parts from the JAX package: a two-view solution whose
  inliers triangulate outside the depth window (0.1, 100) is skipped,
  on the first two frames of the 480 x 640 depth-free sequence of
  chip_smoke.py with draws that give one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gslam_tpu.datasets.synthetic import SyntheticDataset as JData
from gslam_tpu.eval import evaluate_trajectory as j_eval
from gslam_tpu.estimation.init2view import two_view_geometry as j_two_view
from gslam_tpu.models.keyframe_slam import KeyframeSLAM as JSLAM
from gslam_tpu.models.keyframe_slam import SLAMConfig as JConfig
from gslam_tpu.ops.frontend import extract_features as j_extract
from gslam_tpu.ops.matching import match_descriptors as j_match
from gslam_tpu_torch import convert
from chip_smoke import MONO_SEQUENCE, MONO_TEXTURED, SLAM_CFG, ReferenceDraws
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.estimation.epipolar import triangulate
from gslam_tpu_torch.estimation.init2view import (
    two_view_draws, two_view_geometry,
)
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.ops.frontend import extract_features
from gslam_tpu_torch.ops.matching import match_descriptors
from tests.test_torch_arena import jfields
from tests.test_torch_batch import assert_same_run, port_run
from tests.test_torch_slam import CFG, datasets, port_features, run

torch.set_num_threads(2)

N_FRAMES = 16


def test_initialize_in_lockstep():
    dj, dt = datasets(n_frames=2, depth=False)
    fj, ft = list(dj), list(dt)
    js = JSLAM(dj.camera, JConfig(**CFG))
    js.track(fj[0])
    assert not js.initialized and js._prev_feats is not None
    keys = []
    next_key = js._next_key

    def recorded_key():
        keys.append(next_key())
        return keys[-1]

    js._next_key = recorded_key
    js.track(fj[1])
    assert js.initialized and len(keys) == 1
    ke, kh = jax.random.split(keys[0])
    draws = (torch.as_tensor(np.asarray(jax.random.uniform(ke, (256, 8)))),
             torch.as_tensor(np.asarray(jax.random.uniform(kh, (256, 4)))))

    feats_j = [j_extract(jnp.asarray(f.image), max_kps=CFG["max_kps"],
                         threshold=CFG["fast_threshold"], use_pallas=False)
               for f in fj]
    feats_t = [port_features(f) for f in feats_j]
    # the matches and the two-view geometry the bootstrap computes
    m_j = j_match(feats_j[0].desc, feats_j[0].valid, feats_j[1].desc,
                  feats_j[1].valid)
    m_t = match_descriptors(feats_t[0].desc, feats_t[0].valid,
                            feats_t[1].desc, feats_t[1].valid)
    np.testing.assert_array_equal(m_t.idx.numpy(), np.asarray(m_j.idx))
    np.testing.assert_array_equal(m_t.valid.numpy(), np.asarray(m_j.valid))
    assert int(m_t.count) >= 30
    cam_j, cam_t = dj.camera, dt.camera
    r1_j = cam_j.unproject(feats_j[0].uv)[:, :2]
    r2_j = cam_j.unproject(feats_j[1].uv[m_j.idx.clip(0)])[:, :2]
    tv_j = j_two_view(keys[0], r1_j, r2_j, m_j.valid,
                      sigma=1.0 / float(cam_j.fx))
    r1_t = cam_t.unproject(feats_t[0].uv)[:, :2]
    r2_t = cam_t.unproject(feats_t[1].uv[m_t.idx.clamp_min(0).long()])[:, :2]
    tv_t = two_view_geometry(r1_t, r2_t, m_t.valid, sigma=1.0 / cam_t.fx,
                             uniforms=draws)
    assert bool(tv_t.used_h) == bool(tv_j.used_h)
    assert abs(int(tv_t.n_inliers) - int(tv_j.n_inliers)) <= 1
    assert int(tv_t.n_inliers) >= 20
    np.testing.assert_allclose(tv_t.T_21.numpy(), np.asarray(tv_j.T_21),
                               atol=1e-3)
    # in float64 (the JAX package's float64 draws) the two agree
    with jax.enable_x64(True):
        f64 = [np.asarray(a, np.float64) for a in (r1_j, r2_j)]
        tv_j64 = j_two_view(keys[0], *(jnp.asarray(a) for a in f64),
                            m_j.valid, sigma=1.0 / float(cam_j.fx))
        draws64 = tuple(torch.as_tensor(np.asarray(jax.random.uniform(
            k, (256, n), dtype=jnp.float64))) for k, n in ((ke, 8), (kh, 4)))
    tv_t64 = two_view_geometry(*(torch.as_tensor(a) for a in f64),
                               m_t.valid, sigma=1.0 / cam_t.fx,
                               uniforms=draws64)
    np.testing.assert_array_equal(tv_t64.inliers.numpy(),
                                  np.asarray(tv_j64.inliers))
    np.testing.assert_allclose(tv_t64.T_21.numpy(), np.asarray(tv_j64.T_21),
                               atol=1e-9)

    # the port's bootstrap on the same features and draws
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**CFG), device="cpu",
                      uniforms=lambda: draws)
    ts._prev_feats, ts._prev_frame = feats_t[0], ft[0]
    ts._cur_kp_depth = None
    ts._initialize(ft[1], feats_t[1])
    assert ts.initialized and ts.last_kf_id == js.last_kf_id == 1
    assert ts._n_frames_host == js._n_frames_host == 2
    a_j, a_t = jfields(js.arena), convert.arena_to_numpy(ts.arena)
    for name in ("n_frames", "n_points", "n_obs", "obs_frame", "obs_point",
                 "obs_kp", "obs_valid", "point_valid", "point_desc",
                 "point_ref_frame", "frame_valid", "frame_desc",
                 "frame_kp_count", "frame_kp_depth"):
        np.testing.assert_array_equal(a_t[name], a_j[name], err_msg=name)
    np.testing.assert_array_equal(a_t["frame_pose"][1, :7],
                                  tv_t.T_21.numpy())
    np.testing.assert_allclose(a_t["frame_pose"], a_j["frame_pose"],
                               atol=1e-3)
    dist = np.linalg.norm(a_t["point_xyz"] - a_j["point_xyz"], axis=-1)
    assert (dist <= 1e-3 * np.linalg.norm(a_j["point_xyz"], axis=-1)).all()
    np.testing.assert_allclose(ts.pose_wc.numpy(), np.asarray(js.pose_wc),
                               atol=1e-3)


def test_batch_equals_sequential_without_depth():
    cfg = dict(CFG, kf_min_gap=2, kf_max_gap=5)
    _, dt = datasets(n_frames=N_FRAMES, depth=False)
    frames = list(dt)
    seq, _ = port_run(frames, dt.camera, cfg, batched=False)
    bat, poses = port_run(frames, dt.camera, dict(cfg, dispatch_batch=4),
                          batched=True)
    assert len(poses) == N_FRAMES and seq.initialized
    assert_same_run(seq, bat)
    assert bat._n_frames_host >= 4
    assert bat.timer.stats()["slam/track_batch"]["count"] >= 2


def test_whole_slice_without_depth_against_reference():
    dj, dt = datasets(n_frames=N_FRAMES, depth=False)
    js = JSLAM(dj.camera, JConfig(**CFG))
    t, gt = run(js, dj)
    ate_j = j_eval(t, js.positions(), t, gt, with_scale=True).ate_rmse
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**CFG), device="cpu")
    t, gt = run(ts, dt)
    m = evaluate_trajectory(t, ts.positions(), t, gt, with_scale=True)

    def first_mapped(slam):
        return next(i for i, s in enumerate(slam.stats) if s["n_kf"] > 0)

    assert ts.initialized and first_mapped(ts) == first_mapped(js)
    assert abs(ts._n_frames_host - js._n_frames_host) <= 1
    assert ts._n_frames_host >= 3
    assert m.n_matched == N_FRAMES
    assert m.ate_rmse <= max(0.05, 2.0 * ate_j + 0.01)
    assert min(s["n_inliers"] for s in ts.stats[first_mapped(ts) + 1:]) >= 20


def mono_run(sequence, n_frames, seed=0, draws=None):
    ds = SyntheticDataset(**sequence)
    ds.open("synth://")
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**SLAM_CFG, seed=seed),
                        device="cpu", uniforms=draws)
    if draws is not None:
        draws.slam = slam
    frames = [ds.grab_frame() for _ in range(n_frames)]
    t, gt = run(slam, frames)
    return slam, t, gt


def test_vga_frames_with_reference_draws():
    draws = ReferenceDraws(device="cpu")
    slam, _, _ = mono_run(MONO_SEQUENCE, 10, draws=draws)
    inliers = [s["n_inliers"] for s in slam.stats]
    ref = draws.inliers[:10]
    assert draws.taken == 9 and draws.kind[:9] == [1] + [0] * 8
    assert inliers[:2] == ref[:2] == [0, 0] and slam._n_frames_host >= 2
    assert max(abs(a - b) for a, b in zip(inliers, ref)) <= 4
    assert min(inliers[2:]) >= 20


def test_bootstrap_skips_points_outside_the_depth_window():
    """Frames 0 and 1 of chip_smoke.py's VGA line sequence without depth:
    the draws of generator seed 14 give 90 two-view inliers (the JAX
    package's gate takes the pair) of which one triangulates at a depth
    in (0.1, 100); the port skips the pair and waits for the next
    frame.  Seed 0's draws give a map."""
    ds = SyntheticDataset(n_frames=48, n_points=1200, width=640, height=480,
                          motion="line", depth=False, texture=True,
                          noise=0.01)
    ds.open("synth://")
    frames = [ds.grab_frame() for _ in range(2)]
    cam = ds.camera
    for seed, mapped in ((14, False), (0, True)):
        def draws():
            return two_view_draws(256, torch.Generator().manual_seed(seed))

        slam = KeyframeSLAM(cam, SLAMConfig(max_kps=512, fast_threshold=0.08),
                            device="cpu", uniforms=draws)
        for fr in frames:
            slam.track(fr)
        feats = slam._prev_feats          # frame 1's
        assert slam.initialized == mapped
        if mapped:
            assert int(slam.arena.n_points) >= 20
            continue
        assert int(slam.arena.n_frames) == 0
        # the pair that was skipped: many inliers, one point in the window
        slam2 = KeyframeSLAM(cam, SLAMConfig(max_kps=512, fast_threshold=0.08),
                             device="cpu")
        slam2.track(frames[0])
        pf = slam2._prev_feats
        m = match_descriptors(pf.desc, pf.valid, feats.desc, feats.valid)
        r1 = cam.unproject(pf.uv)[:, :2]
        r2 = cam.unproject(feats.uv[m.idx.clamp_min(0).long()])[:, :2]
        tv = two_view_geometry(r1, r2, m.valid, sigma=1.0 / cam.fx,
                               uniforms=draws())
        _, d1 = triangulate(slam._identity(), tv.T_21, r1, r2)
        good = tv.inliers & (d1 > 0.1) & (d1 < 100.0)
        assert int(tv.n_inliers) >= 20 and int(good.sum()) < 20


def seed_spread(sequence, jax_seeds, port_seeds):
    """Frames tracked, keyframes and ATE after scale alignment of both
    packages' runs of ``sequence`` under chip_smoke.py's configuration,
    one per RANSAC seed; for chip_smoke.py's sequence also the port's run
    with the JAX package's recorded seed-0 draws replayed."""
    n = sequence["n_frames"]
    out = {"jax": {}, "port": {}}
    for seed in jax_seeds:
        ds = JData(**sequence)
        ds.open("synth://")
        js = JSLAM(ds.camera, JConfig(**SLAM_CFG, seed=seed))
        t, gt = run(js, ds)
        out["jax"][seed] = summary(js, t, gt)
    for seed in port_seeds:
        out["port"][seed] = summary(*mono_run(sequence, n, seed))
    if sequence == MONO_SEQUENCE:
        out["port_with_reference_draws"] = summary(*mono_run(
            sequence, n, draws=ReferenceDraws(device="cpu")))
    return out


def summary(slam, t, gt):
    ev = j_eval if isinstance(slam, JSLAM) else evaluate_trajectory
    return dict(tracked=sum(s["n_inliers"] >= slam.cfg.min_track_inliers
                            for s in slam.stats),
                keyframes=slam._n_frames_host,
                ate_scaled_m=float(ev(t, slam.positions(), t, gt,
                                      with_scale=True).ate_rmse))


def bootstrap_draws(sequence, n_seeds: int = 200) -> dict:
    """The two-view bootstrap on frames 0 and 1 of ``sequence`` with the
    draws of ``n_seeds`` generator seeds: how many give 20 inliers (the
    JAX package's gate) but fewer than 20 points in the depth window
    (0.1, 100) (the port's)."""
    ds = SyntheticDataset(**sequence)
    ds.open("synth://")
    cam = ds.camera
    f0, f1 = (extract_features(torch.as_tensor(ds.grab_frame().image),
                               max_kps=SLAM_CFG["max_kps"],
                               threshold=SLAM_CFG["fast_threshold"])
              for _ in range(2))
    m = match_descriptors(f0.desc, f0.valid, f1.desc, f1.valid)
    r1 = cam.unproject(f0.uv)[:, :2]
    r2 = cam.unproject(f1.uv[m.idx.clamp_min(0).long()])[:, :2]
    ident = torch.tensor([0.0, 0, 0, 1, 0, 0, 0])
    shy = []
    for seed in range(n_seeds):
        tv = two_view_geometry(r1, r2, m.valid, sigma=1.0 / cam.fx,
                               uniforms=two_view_draws(
                                   256, torch.Generator().manual_seed(seed)))
        _, d1 = triangulate(ident, tv.T_21, r1, r2)
        good = int((tv.inliers & (d1 > 0.1) & (d1 < 100.0)).sum())
        if int(tv.n_inliers) >= 20 and good < 20:
            shy.append(seed)
    return dict(seeds=n_seeds, matches=int(m.count),
                inliers_but_few_points=len(shy), seeds_listed=shy)


if __name__ == "__main__":
    import json
    import sys

    modes = ("--seed-spread", "--bootstrap-draws")
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        sys.exit("usage: python tests/test_torch_mono.py " + " | ".join(modes))
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    for label, seq in (("untextured", MONO_SEQUENCE),
                       ("textured", MONO_TEXTURED)):
        if sys.argv[1] == "--seed-spread":
            out = seed_spread(seq, range(3), range(8))
        else:
            out = bootstrap_draws(seq)
        print(label, json.dumps(out), flush=True)
