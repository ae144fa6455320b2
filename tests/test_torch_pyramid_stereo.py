"""Stereo through the pyramid (``StereoSLAM`` with ``n_levels`` > 1) against
its plain reference, ``slambench/plain_pyramid_stereo.py`` (plain PyTorch,
one left keypoint at a time, integer popcounts for the Hamming distances).

* On the CPU: the octave-gated ``ops.stereo.match_stereo`` and
  ``stereo_depth`` equal the plain reference bit for bit on seeded random
  descriptors, positions and levels, and on a rendered pair at 3 and 4
  levels; ``ops.frontend.pyramid_levels`` equals the plain rule of
  ``slot_levels`` over several shapes and budgets; with ``n_levels`` 1
  ``StereoSLAM``'s depths and a short run's poses equal those of the
  one-level path (the right image at one level, the match without
  levels); a short three-level run meets the stereo test's pose gate
  (``tests/test_torch_stereo.py``: ATE under 0.12 m, more than 50 map
  points); the counters ``slam/stereo/coarse_keypoints`` and
  ``slam/stereo/coarse_depths`` equal a host count.  Every tolerance is 0:
  a Hamming distance is an exact integer either way, the gates compare the
  same float32 numbers, and the depth is the same float32 quotient.
* On the card (marker ``cuda``; skips without one): every stereo pair of
  a short window of the ``kitti00_stereo_orb.live`` cell (2000 keypoints
  over 8 levels on both images at 1241x376) gives the plain reference's
  depths bit for bit; the right image's extraction, replayed on its own
  stream, equals the eager extraction on the main stream bit for bit, and
  an episode with the graphs equals one without.  Run there by

      python -m pytest --noconftest -m cuda tests/test_torch_pyramid_stereo.py

  (this file imports neither JAX nor the JAX package).
"""

import numpy as np
import pytest
import torch

import gslam_tpu_torch.models  # noqa: F401  (registers the systems)
from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.map.arena import arena_stats
from gslam_tpu_torch.models import stereo as stereo_mod
from gslam_tpu_torch.models.stereo import StereoSLAM
from gslam_tpu_torch.ops.frontend import (
    extract_features, extract_features_pyramid, image_pyramid,
    pyramid_levels, pyramid_shapes,
)
from gslam_tpu_torch.ops.stereo import match_stereo, stereo_depth
from slambench import plain_pyramid_stereo as plain
from slambench.run import make_frames
from slambench.scene import World

torch.set_num_threads(2)

FX, BASELINE, SCALE = 718.856, 0.5372, 1.2
HALF = dict(width=620, height=188, rate_hz=10, fx=359.428, fy=359.428,
            cx=303.6, cy=92.6, baseline=0.5372)
# tests/test_torch_stereo.py's sequence and tests/test_torch_slam.py's CFG
STEREO = dict(n_frames=12, n_points=400, width=192, height=144,
              motion="line", depth=False, stereo=True, baseline=0.3)
CFG = dict(max_kps=192, fast_threshold=0.1, ba_window=4, ba_points=256,
           ba_iters=3, cap_frames=32, cap_points=2048, cap_obs=8192,
           local_map_size=384)


def random_pair(seed, K=200):
    """Left keypoints on levels 0-7; right ones at a disparity of 2-120
    px, within about 1.5 x the octave band of the left row, on a level 2
    below to 2 above, with a few bits of their descriptor flipped;
    copies (ties) and distractors; a tenth of each side invalid."""
    g = torch.Generator().manual_seed(seed)
    desc_l = torch.randint(-2**31, 2**31, (K, 8), generator=g,
                           dtype=torch.int64).to(torch.int32)
    lev_l = torch.randint(0, 8, (K,), generator=g)
    uv_l = torch.stack([torch.rand(K, generator=g) * 1100 + 130,
                        torch.rand(K, generator=g) * 370], -1)
    flips = torch.randint(0, 2, (K, 8), generator=g, dtype=torch.int32) \
        << torch.randint(0, 31, (K, 8), generator=g, dtype=torch.int32)
    desc_r = desc_l ^ flips
    band = 2.0 * SCALE ** lev_l.to(torch.float32)
    uv_r = uv_l - torch.stack([torch.rand(K, generator=g) * 118 + 2,
                               (torch.rand(K, generator=g) * 3 - 1.5)
                               * band], -1)
    lev_r = (lev_l + torch.randint(-2, 3, (K,), generator=g)).clamp(0, 7)
    # ties: a copy of each of the first 20 right keypoints, 3 px further
    desc_r = torch.cat([desc_r, desc_r[:20]])
    uv_r = torch.cat([uv_r, uv_r[:20] - torch.tensor([3.0, 0.0])])
    lev_r = torch.cat([lev_r, lev_r[:20]])
    dist = torch.randint(-2**31, 2**31, (40, 8), generator=g,
                         dtype=torch.int64).to(torch.int32)
    desc_r = torch.cat([desc_r, dist])
    uv_r = torch.cat([uv_r, torch.rand(40, 2, generator=g) * 370])
    lev_r = torch.cat([lev_r, torch.randint(0, 8, (40,), generator=g)])
    valid_l = torch.rand(K, generator=g) > 0.1
    valid_r = torch.rand(len(desc_r), generator=g) > 0.1
    return desc_l, valid_l, uv_l, lev_l, desc_r, valid_r, uv_r, lev_r


def check_gated(desc_l, valid_l, uv_l, lev_l, desc_r, valid_r, uv_r, lev_r,
                fx, baseline, scale=SCALE):
    """The program's octave-gated match and depth against the plain
    reference's; the number of matches."""
    disp, ok = match_stereo(desc_l, valid_l, uv_l, desc_r, valid_r, uv_r,
                            levels_l=lev_l, levels_r=lev_r, scale=scale)
    p_disp, p_ok = plain.stereo_match(desc_l, valid_l, uv_l, lev_l, desc_r,
                                      valid_r, uv_r, lev_r, scale)
    assert torch.equal(ok, p_ok)
    assert torch.equal(disp, p_disp)
    depth = stereo_depth(disp, ok, fx, baseline)
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros(()))
    assert torch.equal(depth, plain.stereo_depth(p_disp, p_ok, fx,
                                                 baseline))
    return int(ok.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gated_match_and_depth_on_random_keypoints(seed):
    case = random_pair(seed)
    n = check_gated(*case, FX, BASELINE)
    assert n > 60                       # the case has matches to compare
    # the gate bites: without levels more left keypoints find a match
    desc_l, valid_l, uv_l, _, desc_r, valid_r, uv_r, _ = case
    _, ok = match_stereo(desc_l, valid_l, uv_l, desc_r, valid_r, uv_r,
                         v_tol=2.0 * SCALE ** 7)
    assert int(ok.sum()) > n


@pytest.mark.parametrize("shape", [
    (376, 1241, 8, 1.2, 2000), (480, 640, 8, 1.2, 1000),
    (144, 192, 3, 1.25, 192), (188, 620, 4, 1.2, 384),
    (376, 1241, 8, 1.2, 150)],
    ids=["kitti-orb", "tum-orb", "small", "half-kitti", "floor-of-8"])
def test_pyramid_levels_against_the_plain_rule(shape):
    H, W, n, scale, K = shape
    got = pyramid_levels(pyramid_shapes(H, W, n, scale), K)
    want = plain.slot_levels(H, W, n, scale, K)
    assert got.dtype == np.int64 and len(got) == K
    assert torch.equal(torch.as_tensor(got), want)
    assert int(want[-1]) == n - 1 and bool((want[1:] >= want[:-1]).all())


def test_slot_levels_are_where_the_pyramid_puts_its_keypoints():
    """The slots of level l hold that level's own extraction, its uv
    mapped to level 0."""
    frames, _ = scene()
    img = torch.as_tensor(frames[0].image)
    f = extract_features_pyramid(img, max_kps=192, threshold=0.1,
                                 n_levels=3, scale=1.25)
    lev = torch.as_tensor(pyramid_levels(pyramid_shapes(*img.shape, 3, 1.25),
                                         192))
    for level, lvl in enumerate(image_pyramid(img, 3, 1.25)):
        m = lev == level
        own = extract_features(lvl, max_kps=int(m.sum()), threshold=0.1)
        assert int(own.count) > 5
        assert torch.equal(f.uv[m], own.uv * float(np.float32(1.25 ** level)))
        assert torch.equal(f.desc[m], own.desc)


@pytest.fixture(scope="module")
def rendered_pair():
    sc = dict(scene_seed=3, lap_frames=8, motion="line", step=0.82,
              n_points=1500, n_texture=5000, world_extent=4.0, dot_half=1,
              noise=0.01, exposure=0.0, depth=False, stereo=True)
    ep = World(sc, HALF, "cpu").episode(2, 11)
    return make_frames(dict(sensor=HALF, scene=sc), ep)


@pytest.mark.parametrize("n_levels", [3, 4])
def test_gated_match_on_a_rendered_pair(rendered_pair, n_levels):
    fr = rendered_pair[0]
    left = torch.as_tensor(fr.image)
    right = torch.as_tensor(fr.image_right)
    fl = extract_features_pyramid(left, 384, 0.08, n_levels, SCALE)
    frr = extract_features_pyramid(right, 384, 0.08, n_levels, SCALE)
    lev = plain.slot_levels(HALF["height"], HALF["width"], n_levels, SCALE,
                            384)
    n = check_gated(fl.desc, fl.valid, fl.uv, lev, frr.desc, frr.valid,
                    frr.uv, lev, HALF["fx"], HALF["baseline"])
    assert n > 150
    # and the system's own depths: its right image through the same
    # pyramid, the plain depth (fx as the system holds it, the camera's
    # float32 intrinsics)
    slam = SLAMS.create("stereo", fr.camera, device="cpu", max_kps=384,
                        fast_threshold=0.08, n_levels=n_levels,
                        pyramid_scale=SCALE)
    got = slam._stereo_depths(fr, fl)
    p_disp, p_ok = plain.stereo_match(fl.desc, fl.valid, fl.uv, lev,
                                      frr.desc, frr.valid, frr.uv, lev,
                                      SCALE)
    assert torch.equal(got, plain.stereo_depth(p_disp, p_ok, slam.camera.fx,
                                               HALF["baseline"]))


def scene(n_frames=12):
    ds = SyntheticDataset(**dict(STEREO, n_frames=n_frames))
    ds.open("synth://")
    return list(ds), ds.camera


class OneLevelStereo(StereoSLAM):
    """The one-level path as it was: the right image through
    ``extract_features``, the match without levels."""

    def _stereo_depths(self, frame, feats):
        c = self.cfg
        fr = extract_features(torch.as_tensor(frame.image_right),
                              max_kps=c.max_kps, threshold=c.fast_threshold,
                              use_kernels=c.use_kernels)
        disp, ok = match_stereo(feats.desc, feats.valid, feats.uv, fr.desc,
                                fr.valid, fr.uv,
                                max_disparity=self.max_disparity)
        depth = stereo_depth(disp, ok, self.camera.fx, frame.stereo_baseline)
        return torch.where(torch.isfinite(depth), depth, depth.new_zeros(()))


def test_one_level_depths_and_poses_are_the_one_level_path():
    frames, camera = scene()
    new = SLAMS.create("stereo", camera, device="cpu", **CFG)
    old = OneLevelStereo(camera, new.cfg, device="cpu")
    fr = frames[3]
    feats = extract_features(torch.as_tensor(fr.image), 192, 0.1)
    assert torch.equal(new._stereo_depths(fr, feats),
                       old._stereo_depths(fr, feats))
    for f in frames:
        new.track(f)
        old.track(f)
    assert torch.equal(torch.stack(new.trajectory),
                       torch.stack(old.trajectory))
    assert new.stats == old.stats
    st = new.timer.stats()
    assert st["slam/stereo/extract"]["parent"] == "slam/stereo"
    # the frames, and the one pair before them
    assert st["slam/stereo/match"]["count"] == len(frames) + 1
    # one level: no coarse keypoint to count
    assert "slam/stereo/coarse_keypoints" not in st


def test_pyramid_stereo_slam_meets_the_stereo_gate():
    frames, camera = scene()
    slam = SLAMS.create("stereo", camera, device="cpu",
                        **dict(CFG, n_levels=3, pyramid_scale=SCALE))
    for f in frames:
        slam.track(f)
    t = np.asarray([f.timestamp for f in frames])
    gt = np.stack([f.gt_pose[:3] for f in frames])
    m = evaluate_trajectory(t, slam.positions(), t, gt, with_scale=False)
    assert m.n_matched == len(frames)
    assert m.ate_rmse < 0.12
    assert arena_stats(slam.arena)["valid_points"] > 50
    st = slam.timer.stats()
    assert st["slam/stereo/coarse_keypoints"]["count"] == len(frames)
    assert st["slam/stereo/coarse_depths"]["total"] > 0


def test_coarse_counters_equal_a_host_count():
    frames, camera = scene(n_frames=3)
    slam = SLAMS.create("stereo", camera, device="cpu",
                        **dict(CFG, n_levels=3, pyramid_scale=SCALE))
    lev = plain.slot_levels(144, 192, 3, SCALE, 192)
    want = np.zeros(4)
    for fr in frames:
        left = torch.as_tensor(fr.image)
        fl = extract_features_pyramid(left, 192, 0.1, 3, SCALE)
        frr = extract_features_pyramid(torch.as_tensor(fr.image_right), 192,
                                       0.1, 3, SCALE)
        slam._stereo_depths(fr, fl)
        _, ok = plain.stereo_match(fl.desc, fl.valid, fl.uv, lev, frr.desc,
                                   frr.valid, frr.uv, lev, SCALE)
        coarse = lev > 0
        want += [int(fl.valid.sum()), int(ok.sum()),
                 int((fl.valid & coarse).sum()), int((ok & coarse).sum())]
    st = slam.timer.stats()
    got = [st[f"slam/stereo/{n}"] for n in ("keypoints", "depths",
                                            "coarse_keypoints",
                                            "coarse_depths")]
    assert [s["count"] for s in got] == [len(frames)] * 4
    assert [s["total"] for s in got] == list(want)
    assert want[3] > 0


@pytest.mark.parametrize("measured", [False, True])
def test_an_unmeasured_velocity_takes_twice_the_floor(measured):
    """Until an accepted frame measures the velocity, a motion-model pose
    needs twice ``min_track_inliers`` (``track`` and the batch's first
    frame alike); a pose under that goes to the reference-keyframe path."""
    frames, camera = scene(n_frames=2)
    slam = SLAMS.create("stereo", camera, device="cpu", **CFG)
    slam.track(frames[0])
    slam._velocity_measured = measured
    floor = slam.cfg.min_track_inliers
    assert slam._track_floor() == (floor if measured else 2 * floor)
    x = slam._batch_inputs(torch.zeros(2, 144, 192), torch.zeros(2, 256, 4),
                           *slam._slab(slam.arena, "slam/track_batch")[1:])
    assert int(x["floor0"]) == slam._track_floor()
    track = slam._track_local_map
    calls = []

    def weak(feats, pred, *a, **kw):
        T, m, n, jump, nf = track(feats, pred, *a, **kw)
        calls.append(kw.get("span", "slam/track_fused"))
        # a pose between the two floors, where the prediction put it
        return T, m, floor + 1, 0.0, nf

    slam._track_local_map = weak
    slam.track(frames[1])
    assert calls == ["slam/track_fused"] + (
        [] if measured else ["slam/track_ref/local_map"])


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_window_pyramid_stereo_depths_on_the_card(dev, monkeypatch):
    """Every stereo pair of a 3 s window of ``kitti00_stereo_orb.live``:
    the inputs and outputs of the port's match and depth kept on the host,
    then the plain reference over them, a block of 16 frames at a time,
    with the plain rule's slot levels."""
    from slambench import run as bench_run

    seen = []

    def kept_match(*args, **kw):
        disp, ok = match_stereo(*args, **kw)
        seen.append([a.cpu() for a in args]
                    + [kw["levels_l"].cpu(), kw["levels_r"].cpu(),
                       kw["scale"], kw["max_disparity"], disp.cpu(),
                       ok.cpu()])
        return disp, ok

    def kept_depth(disp, ok, fx, baseline):
        depth = stereo_depth(disp, ok, fx, baseline)
        seen[-1] += [fx, baseline, depth.cpu()]
        return depth

    monkeypatch.setattr(stereo_mod, "match_stereo", kept_match)
    monkeypatch.setattr(stereo_mod, "stereo_depth", kept_depth)
    bench = bench_run.load_benchmark()
    _, config, traffic, _ = bench_run.cell_files(bench,
                                                 "kitti00_stereo_orb.live")
    run = bench_run.run_cell(config, traffic, 2147500007, 3.0, False,
                             device=dev)
    assert run.frames > 20 and run.lost == 0
    se, sl = config["sensor"], config["slam"]
    lev = plain.slot_levels(se["height"], se["width"], sl["n_levels"],
                            sl["pyramid_scale"], sl["max_kps"])
    assert len(seen) > run.frames
    for b in range(0, len(seen), 16):
        for (dl, vl, ul, dr, vr, ur, ll, lr, scale, md, disp, ok, fx, base,
             depth) in seen[b:b + 16]:
            assert torch.equal(ll, lev) and torch.equal(lr, lev)
            assert len(dl) == len(dr) == sl["max_kps"]
            assert int((vl & (lev > 0)).sum()) > 677   # coarse levels fill
            p_disp, p_ok = plain.stereo_match(dl, vl, ul, ll, dr, vr, ur,
                                              lr, scale, max_disparity=md)
            assert torch.equal(ok, p_ok)
            assert torch.equal(disp, p_disp)
            depth = torch.where(torch.isfinite(depth), depth,
                                torch.zeros(()))
            assert torch.equal(depth, plain.stereo_depth(p_disp, p_ok, fx,
                                                         base))


def kitti_orb_frames(n):
    """``n`` frames of the ``kitti00_stereo_orb`` configuration's episode,
    rendered on the card, and its SLAM settings."""
    from slambench import run as bench_run

    bench = bench_run.load_benchmark()
    _, config, _, _ = bench_run.cell_files(bench, "kitti00_stereo_orb.live")
    ep = World(config["scene"], config["sensor"], "cuda").episode(n, 77)
    return make_frames(config, ep), config["slam"]


@pytest.mark.cuda
def test_right_stream_replay_equals_eager_on_the_card(dev):
    """The right image's graph, replayed on the system's second stream,
    against the eager pyramid on the main stream; then two 8-frame
    episodes, with graphs and without, give the same poses."""
    from gslam_tpu_torch.ops.cuda.graphs import PROCESS

    frames, slam_cfg = kitti_orb_frames(8)
    PROCESS.clear()
    slam = SLAMS.create("stereo", frames[0].camera, device=dev, **slam_cfg)
    c = slam.cfg
    for fr in frames[:3]:
        got = slam._extract_right(fr)
        want = extract_features_pyramid(
            torch.as_tensor(fr.image_right, device=dev), c.max_kps,
            c.fast_threshold, c.n_levels, c.pyramid_scale)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    st = slam.timer.stats()
    assert st["slam/stereo/graph"]["total"] == 3
    assert st["slam/stereo/capture_s"]["count"] == 1
    keys = [k for k in PROCESS if k[0] == "extract"]
    assert [k[1] for k in keys] == ["slam/stereo"]

    def episode(graphs):
        s = SLAMS.create("stereo", frames[0].camera, device=dev, **slam_cfg)
        s.use_graphs = graphs
        for fr in frames:
            s.track(fr)
        return s

    a, b = episode(True), episode(False)
    assert torch.equal(torch.stack(a.trajectory), torch.stack(b.trajectory))
    assert a.stats == b.stats
    assert a.timer.stats()["slam/stereo/graph"]["total"] == len(frames)
    assert b.timer.stats()["slam/stereo/graph"]["total"] == 0
