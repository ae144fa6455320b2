"""The port's one CUDA-graph mechanism, ``gslam_tpu_torch/ops/cuda/graphs.py``,
and the kernel launch counters it keeps true.

* On the CPU: :func:`graphs.run` with CPU inputs runs the body once,
  eagerly, whether graphs are enabled or not; its replay counter observes
  0, no capture is timed and the cache stays empty.
  :func:`launch_counts` names the nine kernels, each entry its wrapper's
  counter, and :func:`add_launches` moves exactly the counters it names.
* On the card (marker ``cuda``; skips without one): a small body replays
  bit for bit equal to its eager run, and its result does not alias the
  graph's buffers after the next replay; a graph of ``extract_features``
  moves the launch counters by its warm-up and its replays, and by
  nothing for its capture; ``track_batch``'s graph equals ``_batch_body``
  run eagerly on the same inputs, every output bit for bit, and is one
  graph a process: a fresh system of equal parameters and camera replays
  it without a capture.  Run there by

      python -m pytest --noconftest -m cuda tests/test_torch_graphs.py

  (this file imports neither JAX nor the JAX package).
"""

import gc

import numpy as np
import pytest
import torch

from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.ops.cuda import (
    LAUNCH_COUNTERS, add_launches, brief, fastnms, graphs, launch_counts,
    matcher, orient, schur, vocab,
)
from gslam_tpu_torch.ops.frontend import extract_features
from gslam_tpu_torch.utils.timer import Timer

WRAPPERS = {"fastnms": fastnms, "brief": brief, "matcher": matcher,
            "schur": schur, "vocab": vocab, "orient": orient}


def small_body(x):
    a = x["a"]
    return (a * 2.0 + 1.0, (a.sum(), torch.cumsum(a, 0)))


@pytest.mark.parametrize("enabled", [True, False])
def test_run_with_cpu_inputs_is_eager(enabled):
    cache, tm = graphs.GraphCache(), Timer()
    calls = []

    def body(x):
        calls.append(x)
        return small_body(x)

    x = dict(a=torch.arange(6, dtype=torch.float32))
    out = graphs.run(cache, ("small",), body, x, enabled=enabled, timer=tm,
                     span="test/span", replay_counter="test/span/graph")
    want = small_body(x)
    assert len(calls) == 1 and calls[0] is x
    assert all(torch.equal(a, b) for a, b in
               zip(graphs.tensor_leaves(out), graphs.tensor_leaves(want)))
    st = tm.stats()
    assert st["test/span/graph"] == {"count": 1, "total": 0.0,
                                     "kind": "counter"}
    assert "test/span/capture" not in st
    assert "test/span/capture_s" not in st
    assert cache == {}
    graphs.run(cache, ("small",), body, x, enabled=enabled, timer=tm,
               span="test/span")
    assert len(calls) == 2 and tm.stats()["test/span/graph"]["count"] == 1


def test_launch_counts_read_every_wrapper():
    assert set(launch_counts()) == {
        "fast_nms", "brief", "matcher", "gated_matcher", "schur", "ba_cost",
        "schur_partials", "bow_descent", "orientation"}
    got = launch_counts()
    for kernel, (mod, attr) in LAUNCH_COUNTERS.items():
        assert got[kernel] == getattr(WRAPPERS[mod], attr), kernel


def test_add_launches_moves_the_named_counters(monkeypatch):
    for mod, attr in LAUNCH_COUNTERS.values():
        monkeypatch.setattr(WRAPPERS[mod], attr, 10)
    add_launches({"gated_matcher": 3, "ba_cost": -2, "brief": 0})
    got = launch_counts()
    assert got["gated_matcher"] == 13 and got["ba_cost"] == 8
    assert matcher.launches == 10 and schur.schur_launches == 10
    assert all(v == 10 for k, v in got.items()
               if k not in ("gated_matcher", "ba_cost"))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, for a bit-for-bit comparison (NaN equals NaN)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def same_bits(a, b) -> bool:
    la, lb = graphs.tensor_leaves(a), graphs.tensor_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


@pytest.mark.cuda
def test_replay_equals_eager_and_does_not_alias(dev):
    cache, tm = graphs.GraphCache(), Timer()
    x1 = dict(a=torch.linspace(-1.0, 3.0, 4096, device=dev))
    x2 = dict(a=torch.linspace(5.0, -2.0, 4096, device=dev))
    kw = dict(enabled=True, timer=tm, span="test/span",
              replay_counter="test/span/graph")
    out1 = graphs.run(cache, ("small",), small_body, x1, **kw)
    kept = graphs.clone(out1)
    assert same_bits(out1, small_body(x1))
    out2 = graphs.run(cache, ("small",), small_body, x2, **kw)
    assert same_bits(out2, small_body(x2))
    assert same_bits(out1, kept)        # the second replay left it alone
    (graph,) = cache.values()
    ptrs = {t.data_ptr() for t in graphs.tensor_leaves(graph.out)}
    assert not ptrs & {t.data_ptr() for t in graphs.tensor_leaves(out1)}
    assert graph.replays == 2
    st = tm.stats()
    assert (st["test/span/graph"]["count"],
            st["test/span/graph"]["total"]) == (2, 2.0)
    assert st["test/span/capture"]["count"] == 1
    assert st["test/span/capture_s"]["count"] == 1


@pytest.mark.cuda
def test_launch_counters_count_the_card(dev):
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.random((144, 192), dtype=np.float32)).to(dev)
            for _ in range(3)]

    def body(x):
        return extract_features(x["img"], max_kps=192, threshold=0.1)

    eager = body(dict(img=imgs[0]))          # builds the kernels
    before = launch_counts()
    graph = graphs.CapturedGraph(body, dict(img=imgs[0]))
    after_capture = launch_counts()
    assert graph.captured["fast_nms"] == graph.captured["brief"] == 1
    assert graph.captured["orientation"] == 1
    # the warm-up launched the body once; the capture launched nothing
    assert {k: after_capture[k] - before[k] for k in before} \
        == graph.captured
    for img in imgs:
        graph(dict(img=img))
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in before} \
        == {k: n * (1 + graph.replays) for k, n in graph.captured.items()}
    assert graph.replays == len(imgs)
    assert same_bits(graph(dict(img=imgs[0])), eager)


def batch_graphs():
    """The process's ``track_batch`` graphs, by key."""
    return {k: g for k, g in graphs.PROCESS.items() if k[0] == "batch"}


def forget_batch_graphs():
    for k in list(batch_graphs()):
        del graphs.PROCESS[k]


def batch_system(dev, camera, frames, K):
    """A system that tracked ``frames[:4]`` one a call, and the inputs of
    its next K-frame dispatch."""
    slam = KeyframeSLAM(camera, SLAMConfig(
        max_kps=192, fast_threshold=0.1, ba_window=4, ba_points=256,
        ba_iters=3, cap_frames=32, cap_points=2048, cap_obs=8192,
        dispatch_batch=K), device=dev)
    for fr in frames[:4]:
        slam.track(fr)
    imgs = torch.from_numpy(np.stack(
        [fr.image for fr in frames[4:4 + K]])).to(dev)
    slab = slam._slab(slam.arena, "slam/track_batch")
    return slam, slam._batch_inputs(imgs, slam._batch_uniforms(K), *slab[1:])


def synthetic_frames():
    ds = SyntheticDataset(n_frames=12, n_points=300, width=192, height=144,
                          motion="line", depth=True)
    ds.open("synth://")
    return ds.camera, list(ds)


@pytest.mark.cuda
def test_batch_graph_equals_the_eager_body(dev):
    forget_batch_graphs()
    camera, frames = synthetic_frames()
    K = 4
    slam, x = batch_system(dev, camera, frames, K)
    eager = graphs.clone(slam._batch_body(x))
    for _ in range(2):
        out = slam._run_batch(x)
        assert same_bits(out, eager)
    (graph,) = batch_graphs().values()
    assert graph.replays == 2
    assert graph.captured["fast_nms"] == graph.captured["brief"] == K
    assert graph.captured["orientation"] == K
    assert graph.captured["gated_matcher"] == K
    assert int(eager.rows[:, 14].min()) >= 12      # the frames tracked
    assert slam.timer.stats()["slam/track_batch/capture_s"]["count"] == 1


@pytest.mark.cuda
def test_a_fresh_system_replays_the_process_batch_graph(dev):
    """One graph a process for every system of equal parameters and
    camera: a second system captures nothing and replays it bit for bit
    equal to its own eager body, also once the system and the camera that
    captured it are gone; a camera of other parameters gets its own."""
    forget_batch_graphs()
    camera, frames = synthetic_frames()
    K = 4

    def copy(cam, fx_scale=1.0):
        params = cam.params.copy()
        params[0] *= fx_scale
        return Camera(cam.model, cam.width, cam.height, params)

    first, x = batch_system(dev, copy(camera), frames, K)
    first._run_batch(x)
    del first, x
    gc.collect()
    torch.cuda.empty_cache()
    second, x = batch_system(dev, copy(camera), frames, K)
    eager = graphs.clone(second._batch_body(x))
    assert same_bits(second._run_batch(x), eager)
    (graph,) = batch_graphs().values()
    assert graph.replays == 2
    assert "slam/track_batch/capture_s" not in second.timer.stats()
    other, x = batch_system(dev, copy(camera, 1.01), frames, K)
    eager = graphs.clone(other._batch_body(x))
    assert same_bits(other._run_batch(x), eager)
    assert len(batch_graphs()) == 2
    assert other.timer.stats()["slam/track_batch/capture_s"]["count"] == 1
