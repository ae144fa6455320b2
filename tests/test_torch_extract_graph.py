"""A tracked frame's feature extraction as one CUDA graph a process and
shape (``KeyframeSLAM._extract``) against the eager call.

* On the CPU: ``track`` and ``StereoSLAM``'s right image stay eager (the
  counters ``slam/extract/graph`` and ``slam/stereo/graph`` observe 0 a
  call, no graph is cached), and ``_extract`` gives what
  ``extract_features`` (or ``extract_features_pyramid``) gives.
* On the card (marker ``cuda``; skips without one): the graph's features
  equal the eager call's in every ``Features`` field, bit for bit, at
  480x640, 376x1241 and with a three-level pyramid; a ``KeyframeSLAM``
  and a ``StereoSLAM`` episode with ``use_graphs`` True and False give
  the same poses, match counts and inlier counts; the left image's
  features stay as they were after the right image's replay (the two
  images have a graph each, keyed by span); a second system replays the
  first one's graphs without a capture of its own.  Run there by

      python -m pytest --noconftest -m cuda tests/test_torch_extract_graph.py

  (this file imports neither JAX nor the JAX package).
"""

import pytest
import torch

import gslam_tpu_torch.models  # noqa: F401  (registers the systems)
from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.ops.cuda.graphs import PROCESS
from gslam_tpu_torch.ops.frontend import (
    Features, extract_features, extract_features_pyramid,
)

SCENE = dict(n_frames=24, n_points=300, width=192, height=144,
             motion="line", depth=True)
CFG = dict(max_kps=192, fast_threshold=0.1, ba_window=4, ba_points=256,
           ba_iters=3, cap_frames=32, cap_points=2048, cap_obs=8192)
# scene overrides and system of each SLAM variant run here
SYSTEMS = {"keyframe": ({}, "keyframe"),
           "stereo": (dict(depth=False, stereo=True, baseline=0.3),
                      "stereo")}


def extract_graphs():
    """The process's extraction graphs."""
    return [g for k, g in PROCESS.items() if k[0] == "extract"]


def scene(system, **over):
    ds = SyntheticDataset(**{**SCENE, **SYSTEMS[system][0], **over})
    ds.open("synth://")
    return list(ds), ds.camera


def run(device, system, frames, camera, graphs, **cfg):
    slam = SLAMS.create(SYSTEMS[system][1], camera, device=device,
                        **{**CFG, **cfg})
    slam.use_graphs = graphs
    for f in frames:
        slam.track(f)
    return slam


def eager(img, n_levels=1, max_kps=CFG["max_kps"],
          threshold=CFG["fast_threshold"]):
    if n_levels > 1:
        return extract_features_pyramid(img, max_kps=max_kps,
                                        threshold=threshold,
                                        n_levels=n_levels)
    return extract_features(img, max_kps=max_kps, threshold=threshold)


def assert_same(a: Features, b: Features):
    for name, x, y in zip(Features._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_cpu_track_stays_eager(system):
    frames, camera = scene(system)
    PROCESS.clear()
    slam = run("cpu", system, frames[:5], camera, graphs=True)
    st = slam.timer.stats()
    spans = ["slam/extract"] + (["slam/stereo"] if system == "stereo"
                                else [])
    for span in spans:
        assert st[f"{span}/graph"]["count"] == st[span]["count"] == 5
        assert st[f"{span}/graph"]["total"] == 0
        assert f"{span}/capture_s" not in st
    assert ("slam/stereo/graph" in st) == (system == "stereo")
    assert PROCESS == {}


@pytest.mark.parametrize("n_levels,span", [(1, "slam/extract"),
                                           (3, "slam/extract"),
                                           (3, "slam/stereo")])
def test_cpu_extract_equals_extract_features(n_levels, span):
    """``_extract`` on the CPU is the eager extraction of ``cfg``'s
    levels, under either image's span (the right image's goes through
    the same pyramid)."""
    frames, camera = scene("keyframe", n_frames=2)
    slam = SLAMS.create("keyframe", camera, device="cpu",
                        **{**CFG, "n_levels": n_levels})
    img = torch.as_tensor(frames[1].image)
    got = slam._extract(img, span)
    want = eager(img, n_levels)
    assert_same(got, want)
    assert int(got.count) > 20
    assert slam.timer.stats()[f"{span}/graph"]["total"] == 0
    assert PROCESS == {}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


# image shape, levels: the TUM Kinect's VGA, KITTI 00's grey pair, and
# the VGA frame over a three-level pyramid
SHAPES = {"480x640": ((480, 640), 1), "376x1241": ((376, 1241), 1),
          "480x640-pyramid": ((480, 640), 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_graph_equals_eager_extraction_on_the_card(dev, shape):
    (H, W), levels = SHAPES[shape]
    frames, camera = scene("keyframe", n_frames=3, width=W, height=H,
                           n_points=3000)
    PROCESS.clear()
    slam = SLAMS.create("keyframe", camera, device=dev, max_kps=512,
                        fast_threshold=0.06, n_levels=levels)
    for f in frames:
        img = torch.as_tensor(f.image, device=dev)
        want = eager(img, levels, max_kps=512, threshold=0.06)
        got = slam._extract(img, "slam/extract")
        again = slam._extract(img, "slam/extract")
        assert_same(got, want)
        assert_same(again, want)
        assert int(got.count) > 50
    (graph,) = extract_graphs()
    assert graph.replays == 2 * len(frames)
    assert graph.captured["fast_nms"] == graph.captured["brief"] == levels
    assert graph.captured["orientation"] == levels
    st = slam.timer.stats()
    assert st["slam/extract/graph"]["total"] == 2 * len(frames)
    assert st["slam/extract/capture_s"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_graph_replay_equals_eager_episode_on_the_card(dev, system):
    frames, camera = scene(system)
    PROCESS.clear()
    graph = run(dev, system, frames, camera, graphs=True)
    eager_run = run(dev, system, frames, camera, graphs=False)
    again = run(dev, system, frames, camera, graphs=True)
    assert torch.equal(torch.stack(graph.trajectory),
                       torch.stack(eager_run.trajectory))
    assert torch.equal(torch.stack(again.trajectory),
                       torch.stack(eager_run.trajectory))
    assert graph.stats == eager_run.stats == again.stats
    assert all(s["n_inliers"] >= 12 for s in eager_run.stats[1:])
    spans = ["slam/extract"] + (["slam/stereo"] if system == "stereo"
                                else [])
    n = len(frames)
    for span in spans:
        for slam, total in ((graph, n), (eager_run, 0), (again, n)):
            st = slam.timer.stats()[f"{span}/graph"]
            assert (st["count"], st["total"]) == (n, total)
    # each image has a graph of its own (the right image's may replay on
    # another stream while the left image's runs), captured once, and the
    # second system replays the first one's graphs
    for span in spans:
        assert graph.timer.stats()[f"{span}/capture_s"]["count"] == 1
        assert f"{span}/capture_s" not in eager_run.timer.stats()
        assert f"{span}/capture_s" not in again.timer.stats()
    assert len(extract_graphs()) == len(spans)


@pytest.mark.cuda
def test_left_features_survive_the_right_replay(dev):
    frames, camera = scene("stereo", n_frames=2)
    slam = SLAMS.create("stereo", camera, device=dev, **CFG)
    left = torch.as_tensor(frames[1].image, device=dev)
    right = torch.as_tensor(frames[1].image_right, device=dev)
    fl = slam._extract(left, "slam/extract")
    kept = Features(*(x.clone() for x in fl))
    fr = slam._extract(right, "slam/stereo")
    assert_same(fl, kept)
    assert_same(fl, eager(left))
    assert_same(fr, eager(right))
    assert not torch.equal(fl.uv, fr.uv)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(fl, fr))
