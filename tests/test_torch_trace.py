"""The port's timer (``gslam_tpu_torch/utils/timer.py``) as a tracer.

* Spans nest; each child names its parent; ``leave`` of a span not open
  raises.
* Under ``torch.profiler`` on the CPU, ``KeyframeSLAM.track`` over a
  short synthetic sequence opens a range for ``slam/extract``,
  ``slam/track_fused/{slab,match,pnp,fetch}`` and
  ``slam/local_ba/{window,lm,write_back}``, each with ``frame=<id>`` as
  its args; under the benchmark's ``Tracer``, which also wraps
  ``Timer.enter`` / ``Timer.leave``, there is exactly one range a span.
* With no profiler recording a span makes no CUDA call (the CUDA entry
  points are replaced by ones that raise); with one recording on a card
  it records a pair of events, which ``stats()`` resolves into
  ``"<span>:device"``.
* Counters: ``stats()`` reports them with the ``count`` / ``total`` keys
  that ``slambench.run.merge_sections`` sums; a tensor value is summed
  where it lies and read to the host only in ``stats()``.
* The benchmark's twelve readers of these spans and counters on a
  hand-built ``slambench.run.Run``, and on one without them.
* ``play -profile DIR -cpu true`` writes a trace that holds the
  program's spans.
"""

import json
import os

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.utils import timer as timer_module
from gslam_tpu_torch.utils.timer import Timer
from slambench import run as bench_run

torch.set_num_threads(2)

SEQ = dict(n_frames=7, n_points=300, width=192, height=144, motion="line",
           depth=True)
CFG = dict(max_kps=192, fast_threshold=0.1, kf_max_gap=2, ba_iters=2)
TRACK_SPANS = {"slam/extract", "slam/track_fused",
               "slam/track_fused/slab", "slam/track_fused/match",
               "slam/track_fused/pnp", "slam/track_fused/fetch",
               "slam/local_ba", "slam/local_ba/window", "slam/local_ba/lm",
               "slam/local_ba/write_back"}


def dataset(**kw):
    ds = SyntheticDataset(**dict(SEQ, **kw))
    ds.open("synth://")
    return ds


def run_slam(n=None):
    ds = dataset()
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**CFG), device="cpu")
    for i, fr in enumerate(ds):
        if n is not None and i >= n:
            break
        slam.track(fr)
    return slam


def user_ranges(prof):
    """(name, count) of the host's record_function ranges in a trace."""
    got = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            got[ev.name()] = got.get(ev.name(), 0) + 1
    return got


# ---------------------------------------------------------------------------
# spans


def test_spans_nest_and_children_name_their_parent():
    tm = Timer()
    for _ in range(2):
        with tm.section("slam/track_fused"):
            with tm.section("slam/track_fused/slab"):
                pass
            with tm.section("slam/track_fused/pnp"):
                with tm.section("slam/track_fused/pnp/gn"):
                    pass
    with tm.section("slam/extract"):
        pass
    st = tm.stats()
    assert st["slam/track_fused"]["parent"] is None
    assert st["slam/extract"]["parent"] is None
    assert st["slam/track_fused/slab"]["parent"] == "slam/track_fused"
    assert st["slam/track_fused/pnp"]["parent"] == "slam/track_fused"
    assert st["slam/track_fused/pnp/gn"]["parent"] == "slam/track_fused/pnp"
    assert all(s["count"] == 2 for k, s in st.items()
               if k.startswith("slam/track_fused"))
    # a child closes inside its parent: its host time is within it
    assert st["slam/track_fused"]["total"] >= \
        st["slam/track_fused/slab"]["total"] + \
        st["slam/track_fused/pnp"]["total"]
    tm.enter("a")
    tm.enter("a/b")
    tm.leave("a/b")
    tm.leave("a")
    assert tm.stats()["a/b"]["parent"] == "a"
    with pytest.raises(KeyError):
        tm.leave("a")


def test_track_emits_ranges_with_frame_ids(monkeypatch):
    """Each span of ``track`` opens one range of its name, its args the
    frame's id; ``Timer.frame`` follows the frames."""
    seen = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        slam = run_slam()
    assert slam.timer.frame == SEQ["n_frames"] - 1
    st = slam.timer.stats()
    assert TRACK_SPANS <= set(st)
    ranges = user_ranges(prof)
    for name in TRACK_SPANS:
        assert ranges.get(name) == st[name]["count"], name
    frames = {(name, args) for name, args in seen}
    assert ("slam/extract", "frame=0") in frames
    assert ("slam/track_fused/pnp", "frame=1") in frames
    ba = {args for name, args in seen if name == "slam/local_ba/lm"}
    assert ba and all(a.startswith("frame=") for a in ba)
    assert len(seen) == sum(st[n]["count"] for n in st
                            if st[n]["kind"] == "span")
    # the CPU has no device clock
    assert not any(k.endswith(":device") for k in st)


def test_one_range_a_span_under_the_benchmark_tracer():
    from slambench.trace import Tracer

    tracer = Tracer(3600.0)
    tracer.start()
    try:
        slam = run_slam(n=5)
    finally:
        tracer.stop()
    st = slam.timer.stats()
    ranges = user_ranges(tracer.prof)
    spans = {k for k, v in st.items() if v["kind"] == "span"}
    assert {"slam/extract", "slam/track_fused/pnp"} <= spans
    for name in spans:
        assert ranges.get(name) == st[name]["count"], name
    data = tracer.digest()
    assert data.window_s > 0


def test_no_cuda_call_without_a_profiler(monkeypatch):
    """A span reads only the host clock when nothing records; under a
    profiler on a card it records one pair of events, resolved in
    ``stats()``."""

    def boom(*a, **k):
        raise AssertionError("a CUDA call in a span with no profiler")

    for name in ("Event", "is_initialized", "is_current_stream_capturing",
                 "synchronize", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, boom)
    assert not autograd_profiler._is_profiler_enabled
    tm = Timer()
    for _ in range(3):
        with tm.section("slam/extract"):
            with tm.section("slam/extract/part"):
                pass
    assert set(tm.stats()) == {"slam/extract", "slam/extract/part"}

    made = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self):
            self.t = len(made)

        def query(self):
            return True

        def elapsed_time(self, end):
            return 2.0 * (end.t - self.t)

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with profile(activities=[ProfilerActivity.CPU]):
        with tm.section("slam/extract"):
            pass
    assert len(made) == 2
    st = tm.stats()
    dev = st["slam/extract:device"]
    assert dev["kind"] == "device" and dev["count"] == 1
    assert dev["total"] == pytest.approx(2e-3)
    assert st["slam/extract"]["count"] == 4
    # a long profiled run folds the passed pairs as it goes
    monkeypatch.setattr(timer_module, "_MAX_PENDING", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tm.section("slam/extract"):
                pass
    assert len(made) == 8 and not tm._pending
    assert tm.stats()["slam/extract:device"]["count"] == 4
    # graph capture: no events
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with profile(activities=[ProfilerActivity.CPU]):
        with tm.section("slam/extract"):
            pass
    assert len(made) == 8


# ---------------------------------------------------------------------------
# counters


class HostReads(TorchDispatchMode):
    """Counts the operations that read a tensor's value to the host."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.item.default):
            self.reads += 1
        return func(*args, **(kwargs or {}))


def test_counters_merge_and_read_tensors_only_in_stats():
    a, b = Timer(), Timer()
    mode = HostReads()
    with mode:
        for v in (3, 4):
            a.count("slam/track_fused/inliers", v)
        for _ in range(2):
            b.count("slam/local_ba/lm_accepted",
                    torch.tensor([True, False, True]).sum())
    assert mode.reads == 0
    with mode:
        st = b.stats()
    assert mode.reads == 1
    assert st["slam/local_ba/lm_accepted"] == {
        "count": 2, "total": 4.0, "kind": "counter"}
    with a.section("slam/track_fused"):
        pass
    into = {}
    for t in (a, b, a):
        bench_run.merge_sections(into, t)
    assert into["slam/track_fused/inliers"] == {"count": 4, "total": 14.0}
    assert into["slam/local_ba/lm_accepted"] == {"count": 2, "total": 4.0}
    assert into["slam/track_fused"]["count"] == 2
    m = Timer.merged(a, b)
    assert m.stats()["slam/track_fused/inliers"]["total"] == 7.0
    table = m.table()
    assert "counter" in table and "slam/local_ba/lm_accepted" in table
    m.reset()
    assert m.stats() == {}


def test_track_counters():
    """``track``'s counters match its stats rows; local BA counts its
    LM iterations and accepted steps."""
    slam = run_slam()
    st = slam.timer.stats()
    tracked = slam.stats[1:]
    assert st["slam/track_fused/matches"]["count"] == len(tracked)
    assert st["slam/track_fused/matches"]["total"] == \
        sum(r["n_matches"] for r in tracked)
    assert st["slam/track_fused/inliers"]["total"] == \
        sum(r["n_inliers"] for r in tracked)
    n_ba = st["slam/local_ba"]["count"]
    assert n_ba >= 1
    assert st["slam/local_ba/lm_iters"] == {
        "count": n_ba, "total": float(n_ba * CFG["ba_iters"]),
        "kind": "counter"}
    acc = st["slam/local_ba/lm_accepted"]
    assert acc["count"] == n_ba and 0 <= acc["total"] <= n_ba * 2


def test_track_batch_counters():
    ds = dataset(n_frames=10)
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**dict(
        CFG, kf_max_gap=8, dispatch_batch=4)), device="cpu")
    slam.track_batch(list(ds))
    st = slam.timer.stats()
    acc = st["slam/track_batch/accepted"]
    assert acc["count"] == len(slam.batch_accepted) >= 1
    assert acc["total"] == sum(slam.batch_accepted)
    assert st["slam/track_batch/matches"]["count"] == acc["total"]
    assert st["slam/track_batch/fetch"]["parent"] == "slam/track_batch"
    # the CPU runs the body eagerly: nothing is captured
    assert "slam/track_batch/capture" not in st
    assert "slam/track_batch/capture_s" not in st


# ---------------------------------------------------------------------------
# the benchmark's readers


def hand_run():
    """A ``Run`` of 100 frames, the first 40 in the traced part."""
    def s(count, total):
        return {"count": count, "total": total}

    run = bench_run.Run(config={"slam": {"dispatch_batch": 1}},
                        traffic={"slam": {"dispatch_batch": 8}},
                        device="cpu", episode=None)
    run.frames, run.traced_frames = 100, 40
    run.sections = {
        "slam/track_fused/slab": s(90, 0.9),
        "slam/track_fused/match": s(90, 0.6),
        "slam/track_fused/pnp": s(90, 1.2),
        "slam/track_fused/fetch": s(90, 0.3),
        "slam/extract:device": s(40, 0.08),
        "slam/local_ba:device": s(5, 0.05),
        "slam/track_fused/matches": s(90, 9000),
        "slam/track_fused/inliers": s(90, 6000),
        "slam/track_batch/matches": s(10, 1000),
        "slam/track_batch/inliers": s(10, 900),
        "slam/local_ba/lm_iters": s(10, 60),
        "slam/local_ba/lm_accepted": s(10, 42),
        "slam/track_batch/accepted": s(12, 60),
        "slam/track_batch/capture_s": s(3, 0.6),
        "slam/extract/graph": s(100, 95),
        "slam/stereo/graph": s(100, 100),
        "slam/track_fused/slab_hit": s(90, 75),
        "slam/stereo/match": s(90, 0.45),
        "slam/stereo/extract:device": s(40, 0.12),
        "slam/stereo/coarse_keypoints": s(100, 100000),
        "slam/stereo/coarse_depths": s(100, 80000),
    }
    run.traced_sections = {
        "slam/track_fused/slab": s(30, 0.6),
        "slam/track_fused/match": s(30, 0.3),
        "slam/track_fused/pnp": s(30, 0.6),
        "slam/track_fused/fetch": s(30, 0.12),
        "slam/extract:device": s(40, 0.08),
        "slam/local_ba:device": s(5, 0.05),
        "slam/track_fused/matches": s(30, 3000),
        "slam/track_fused/inliers": s(30, 1500),
        "slam/local_ba/lm_iters": s(5, 30),
        "slam/local_ba/lm_accepted": s(5, 30),
        "slam/track_batch/accepted": s(4, 32),
        "slam/track_batch/capture_s": s(1, 0.3),
        "slam/extract/graph": s(40, 40),
        "slam/stereo/graph": s(40, 40),
        "slam/track_fused/slab_hit": s(30, 27),
        "slam/stereo/match": s(30, 0.15),
        "slam/stereo/extract:device": s(40, 0.12),
        "slam/stereo/coarse_keypoints": s(40, 40000),
        "slam/stereo/coarse_depths": s(40, 34000),
    }
    return run


READ = {
    "slab_ms": 0.3 / 60 * 1e3,
    "match_ms": 0.3 / 60 * 1e3,
    "pnp_ms": 0.6 / 60 * 1e3,
    "track_wait_ms": 0.18 / 60 * 1e3,
    "extract_device_ms": 0.08 / 40 * 1e3,
    "local_ba_device_ms": 0.05 / 5 * 1e3,
    # fused outside the trace 6000 / 4500; batch whole (nothing traced)
    "inlier_pct": 100.0 * (4500 + 900) / (6000 + 1000),
    "lm_accept_pct": 100.0 * 12 / 30,
    "batch_accept_pct": 100.0 * 28 / (8 * 8),
    "capture_ms": 0.3 / 60 * 1e3,
    # both images' counters outside the trace: 55 + 60 replays of 120
    "extract_graph_pct": 100.0 * (55 + 60) / 120,
    # the slab's ids reused outside the trace: 48 of 60 frames
    "slab_hit_pct": 100.0 * 48 / 60,
    "stereo_match_ms": 0.3 / 60 * 1e3,
    "stereo_extract_device_ms": 0.12 / 40 * 1e3,
    # the coarse levels' counters outside the trace
    "coarse_depth_pct": 100.0 * (80000 - 34000) / (100000 - 40000),
}


@pytest.mark.parametrize("metric", sorted(READ))
def test_reader_on_a_hand_built_run(metric):
    got = bench_run.reader(metric)(hand_run())
    assert got == pytest.approx(READ[metric], rel=1e-12)
    # a program without these spans and counters: nothing to read
    empty = bench_run.Run(config={"slam": {}}, traffic={}, device="cpu",
                          episode=None)
    empty.frames, empty.traced_frames = 100, 40
    empty.sections = {"slam/track_fused": {"count": 90, "total": 3.0}}
    empty.traced_sections = {"slam/track_fused": {"count": 30,
                                                  "total": 1.0}}
    assert bench_run.reader(metric)(empty) is None


# ---------------------------------------------------------------------------
# the CLI's -profile


def test_play_profile_holds_the_program_spans(tmp_path):
    from gslam_tpu_torch.app import cli
    from gslam_tpu_torch.app.config import Svar

    path = str(tmp_path / "seq.synth")
    with open(path, "w") as f:
        f.write(json.dumps(dict(SEQ, n_frames=5)))
    pdir = str(tmp_path / "trace")
    s = Svar()
    s.parse_main(["play", "-cpu", "true", "-dataset", path, "-slam",
                  "keyframe", "-profile", pdir, "-slam.max_kps", "192",
                  "-slam.fast_threshold", "0.1", "-slam.kf_max_gap", "2"])
    assert cli.app_play(s) == 0
    events = json.load(open(os.path.join(pdir, "trace.json")))["traceEvents"]
    ranges = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert {"app/frame", "slam/extract", "slam/track_fused/slab",
            "slam/track_fused/match", "slam/track_fused/pnp",
            "slam/track_fused/fetch", "slam/local_ba/lm"} <= ranges
