"""The stereo configuration's operations against their plain reference,
``slambench/plain_stereo.py`` (plain PyTorch, one keypoint at a time,
integer popcounts for the Hamming distances).

* On the CPU: ``ops.stereo.match_stereo`` / ``stereo_depth`` (the port's
  stereo depth, a dense float32 distance matrix from a matrix product)
  and the matching of the path that tracks a frame against its reference
  keyframe (``ops.cuda.matcher.match_hamming``, ratio 0.9 with the mutual
  check) equal the plain reference on seeded random descriptors and
  keypoints, ties included, and on one rendered pair of KITTI 00's
  geometry at half scale.  Every tolerance is 0: a Hamming distance of 256
  bits is an exact integer in float32 either way, the gates compare the
  same float32 numbers, and the depth is the same float32 quotient.
* On the card (marker ``cuda``; skips without one): the stereo depths of
  every frame of a short window of the ``kitti00_stereo.live`` cell at
  1241x376 (B1 and B2 on both images, the port's match and depth on the
  card) equal the plain reference computed on the host from the same
  keypoints and descriptors, in blocks of frames, to the bit.  Run there
  by

      python -m pytest --noconftest -m cuda tests/test_torch_stereo_plain.py

  (this file imports neither JAX nor the JAX package).
"""

import pytest
import torch

import gslam_tpu_torch.models  # noqa: F401  (registers the systems)
from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.models import stereo as stereo_mod
from gslam_tpu_torch.ops.cuda.matcher import match_hamming
from gslam_tpu_torch.ops.frontend import extract_features
from gslam_tpu_torch.ops.stereo import match_stereo, stereo_depth
from slambench import plain_stereo
from slambench.run import make_frames
from slambench.scene import World

torch.set_num_threads(2)

FX, BASELINE = 718.856, 0.5372
HALF = dict(width=620, height=188, rate_hz=10, fx=359.428, fy=359.428,
            cx=303.6, cy=92.6, baseline=0.5372)


def random_pair(seed, K=160):
    """Left keypoints; right ones at a disparity of 2-120 px on nearly
    the same row with a few bits of their descriptor flipped, duplicates
    (ties) and distractors; a tenth of each side invalid."""
    g = torch.Generator().manual_seed(seed)
    desc_l = torch.randint(-2**31, 2**31, (K, 8), generator=g,
                           dtype=torch.int64).to(torch.int32)
    uv_l = torch.stack([torch.rand(K, generator=g) * 1100 + 130,
                        torch.rand(K, generator=g) * 370], -1)
    flips = torch.randint(0, 2, (K, 8), generator=g, dtype=torch.int32) \
        << torch.randint(0, 31, (K, 8), generator=g, dtype=torch.int32)
    desc_r = desc_l ^ flips
    uv_r = uv_l - torch.stack([torch.rand(K, generator=g) * 118 + 2,
                               torch.rand(K, generator=g) * 3 - 1.5], -1)
    # ties: a copy of each of the first 20 right keypoints, 3 px further
    desc_r = torch.cat([desc_r, desc_r[:20]])
    uv_r = torch.cat([uv_r, uv_r[:20] - torch.tensor([3.0, 0.0])])
    dist = torch.randint(-2**31, 2**31, (40, 8), generator=g,
                         dtype=torch.int64).to(torch.int32)
    desc_r = torch.cat([desc_r, dist])
    uv_r = torch.cat([uv_r, torch.rand(40, 2, generator=g) * 370])
    valid_l = torch.rand(K, generator=g) > 0.1
    valid_r = torch.rand(len(desc_r), generator=g) > 0.1
    return desc_l, valid_l, uv_l, desc_r, valid_r, uv_r


def check_stereo(desc_l, valid_l, uv_l, desc_r, valid_r, uv_r, fx,
                 baseline, max_disparity=128.0):
    disp, ok = match_stereo(desc_l, valid_l, uv_l, desc_r, valid_r, uv_r,
                            max_disparity=max_disparity)
    p_disp, p_ok = plain_stereo.stereo_match(desc_l, valid_l, uv_l, desc_r,
                                             valid_r, uv_r,
                                             max_disparity=max_disparity)
    assert torch.equal(ok, p_ok)
    assert torch.equal(disp, p_disp)
    depth = stereo_depth(disp, ok, fx, baseline)
    assert torch.equal(depth, plain_stereo.stereo_depth(p_disp, p_ok, fx,
                                                        baseline))
    return int(ok.sum())


def check_match(desc_a, valid_a, desc_b, valid_b):
    m = match_hamming(desc_a, valid_a, desc_b, valid_b, ratio=0.9)
    idx, ok = plain_stereo.match_bruteforce(desc_a, valid_a, desc_b,
                                            valid_b, ratio=0.9)
    assert torch.equal(m.valid, ok)
    assert torch.equal(m.idx.to(torch.int64), idx)
    return int(ok.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stereo_match_and_depth_on_random_keypoints(seed):
    n = check_stereo(*random_pair(seed), FX, BASELINE)
    assert n > 60                       # the case has matches to compare


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_path_match_on_random_descriptors(seed):
    desc_l, valid_l, _, desc_r, valid_r, _ = random_pair(seed)
    assert check_match(desc_r, valid_r, desc_l, valid_l) > 60


@pytest.fixture(scope="module")
def rendered_pair():
    sc = dict(scene_seed=3, lap_frames=8, motion="line", step=0.82,
              n_points=1500, n_texture=5000, world_extent=4.0, dot_half=1,
              noise=0.01, exposure=0.0, depth=False, stereo=True)
    ep = World(sc, HALF, "cpu").episode(2, 11)
    return make_frames(dict(sensor=HALF, scene=sc), ep)


def test_stereo_on_a_rendered_pair(rendered_pair):
    fr = rendered_pair[0]
    fl = extract_features(torch.as_tensor(fr.image), 384, 0.08)
    frr = extract_features(torch.as_tensor(fr.image_right), 384, 0.08)
    n = check_stereo(fl.desc, fl.valid, fl.uv, frr.desc, frr.valid, frr.uv,
                     HALF["fx"], HALF["baseline"])
    assert n > 200
    # and the system's own depths: the plain depth, 0 where not finite
    slam = SLAMS.create("stereo", fr.camera, device="cpu", max_kps=384,
                        fast_threshold=0.08)
    got = slam._stereo_depths(fr, fl)
    p_disp, p_ok = plain_stereo.stereo_match(fl.desc, fl.valid, fl.uv,
                                             frr.desc, frr.valid, frr.uv)
    # fx as the system holds it (the camera's float32 intrinsics)
    want = plain_stereo.stereo_depth(p_disp, p_ok, slam.camera.fx,
                                     HALF["baseline"])
    assert torch.equal(got, torch.where(torch.isfinite(want), want,
                                        torch.zeros(())))


def test_reference_path_match_on_a_rendered_pair(rendered_pair):
    """The map of frame 0 (its points' descriptors, as the path reads
    them from the arena) against frame 1's keypoints."""
    slam = SLAMS.create("stereo", rendered_pair[0].camera, device="cpu",
                        max_kps=384, fast_threshold=0.08)
    slam.track(rendered_pair[0])
    a = slam.arena
    n = int(a.n_points)
    f1 = extract_features(torch.as_tensor(rendered_pair[1].image), 384, 0.08)
    assert check_match(a.point_desc[:n], a.point_valid[:n], f1.desc,
                       f1.valid) > 20


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_window_stereo_depths_on_the_card(dev, monkeypatch):
    """Every stereo pair of a 6 s window of ``kitti00_stereo.live``: the
    inputs and outputs of the port's match and depth kept on the host,
    then the plain reference over them, a block of 16 frames at a time."""
    from slambench import run as bench_run

    seen = []

    def kept_match(*args, **kw):
        disp, ok = match_stereo(*args, **kw)
        seen.append([a.cpu() for a in args] + [kw["max_disparity"],
                                               disp.cpu(), ok.cpu()])
        return disp, ok

    def kept_depth(disp, ok, fx, baseline):
        depth = stereo_depth(disp, ok, fx, baseline)
        seen[-1] += [fx, baseline, depth.cpu()]
        return depth

    monkeypatch.setattr(stereo_mod, "match_stereo", kept_match)
    monkeypatch.setattr(stereo_mod, "stereo_depth", kept_depth)
    bench = bench_run.load_benchmark()
    _, config, traffic, _ = bench_run.cell_files(bench, "kitti00_stereo.live")
    run = bench_run.run_cell(config, traffic, 2147500003, 6.0, False,
                             device=dev)
    assert run.frames > 40 and run.lost == 0
    W = config["sensor"]["width"]
    assert len(seen) > run.frames
    for b in range(0, len(seen), 16):
        for (dl, vl, ul, dr, vr, ur, md, disp, ok, fx, base,
             depth) in seen[b:b + 16]:
            assert float(ul[:, 0][vl].max()) > W / 2   # full width
            p_disp, p_ok = plain_stereo.stereo_match(dl, vl, ul, dr, vr,
                                                     ur, max_disparity=md)
            assert torch.equal(ok, p_ok)
            assert torch.equal(disp, p_disp)
            assert torch.equal(depth, plain_stereo.stereo_depth(
                p_disp, p_ok, fx, base))
