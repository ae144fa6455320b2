"""The port's app layer against the JAX package's: the Svar config, the
Messenger bus, the metrics registry and timer, the HTML viewer and its
geometry, and the evaluation report.

Bit for bit: Svar (every case of tests/test_app.py:22-80 gives the same
positionals, values and ``dump_json()``), Messenger (the same delivery
order, drops and unsubscribes; drops made deterministic by holding the
worker in its first callback), ``MetricsRegistry.summary()``, the viewer
HTML on the same numpy inputs (the template is the reference's byte for
byte), frustum and covisibility segments on an arena carried across
through numpy, ``EvalReport.to_dict()``'s keys and trajectory fields.
"""

import importlib
import json
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.app import config as jconfig
from gslam_tpu.app import webviz as jwebviz
from gslam_tpu.eval import evaluate_trajectory as j_eval
from gslam_tpu.eval.report import EvalReport as JReport
from gslam_tpu.map import arena as ja
from gslam_tpu.utils.metrics import MetricsRegistry as JMetrics
from gslam_tpu_torch.app import config as tconfig
from gslam_tpu_torch.app import webviz as twebviz
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval import EvalReport, evaluate_trajectory
from gslam_tpu_torch.map.arena import arena_to_numpy
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.utils import metrics as tmetrics
from gslam_tpu_torch.utils.png import write_png
from gslam_tpu_torch.utils.timer import Timer, timer

torch.set_num_threads(2)
# the modules (each app package's ``messenger`` attribute is its global
# bus, which shadows the module of that name, in both packages)
jmessenger = importlib.import_module("gslam_tpu.app.messenger")
tmessenger = importlib.import_module("gslam_tpu_torch.app.messenger")


# ---------------------------------------------------------------------------
# Svar: tests/test_app.py:22-80, each case on both packages


def case_arg_default(Svar, tmp_path):
    s = Svar()
    return [s.arg("Dataset.Skip", 3, "skip"), s.get("Dataset.Skip")], s


def case_parse_main_types(Svar, tmp_path):
    s = Svar()
    pos = s.parse_main(["pos0", "-x", "5", "-y", "1.5", "-name", "kitti",
                        "-neg", "-3", "-flag"])
    return [pos, s["x"], type(s["x"]).__name__, s["y"], s["name"],
            s["flag"], s["neg"]], s


def case_dotted_keys(Svar, tmp_path):
    s = Svar()
    s.parse_main(["-Dataset.Skip", "2"])
    return [s.arg("Dataset.Skip", 0), s.get("Dataset")], s


def case_subtree(Svar, tmp_path):
    s = Svar()
    s.parse_main(["-slam", "keyframe", "-slam.max_kps", "128",
                  "-slam.vi_min_factors", "4"])
    return [s.arg("slam", ""), s.subtree("slam"), s.subtree("nope"),
            s.subtree("slam.max_kps")], s


def case_arg_coerces_string(Svar, tmp_path):
    s = Svar()
    s.set("n", "7")
    return [s.arg("n", 0)], s


def case_vec_parament(Svar, tmp_path):
    s = Svar()
    s.set("cam", "0.5 100 3")
    return [s.arg("cam", [0.0])], s


def case_config_file_precedence(Svar, tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text('{"a": 1, "b": {"c": 2}}')
    s = Svar()
    s.parse_main(["-a", "9", "-conf", str(cfg)])
    return [s["a"], s["b.c"]], s


def case_contains_and_missing(Svar, tmp_path):
    s = Svar()
    with pytest.raises(KeyError):
        s["nope"]
    return ["nope" in s], s


def case_cli_flags(Svar, tmp_path):
    """The CLI's own flags: booleans, a scalar beside its subtree, the
    help table after the declarations."""
    s = Svar()
    pos = s.parse_main(["eval", "-dataset", "x.synth", "-cpu", "true",
                        "-slam", "keyframe", "-slam.max_kps", "192",
                        "-slam.fast_threshold", "0.1", "-debug.nojit",
                        "-Dataset.Max", "5"])
    got = [pos, s.arg("cpu", False), s.arg("debug.nojit", False),
           s.arg("debug", False), s.arg("Dataset.Max", 0),
           s.subtree("slam"), s.arg("viz.live", 0)]
    return got + [s.help_table()], s


SVAR_CASES = [case_arg_default, case_parse_main_types, case_dotted_keys,
              case_subtree, case_arg_coerces_string, case_vec_parament,
              case_config_file_precedence, case_contains_and_missing,
              case_cli_flags]


@pytest.mark.parametrize("case", SVAR_CASES, ids=lambda c: c.__name__[5:])
def test_svar_case_same_as_reference(case, tmp_path):
    got_j, s_j = case(jconfig.Svar, tmp_path)
    got_t, s_t = case(tconfig.Svar, tmp_path)
    assert got_t == got_j
    assert s_t.dump_json() == s_j.dump_json()


def test_parse_args_into_the_global_svar():
    s = tconfig.Svar()
    assert tconfig.parse_args(["-k", "3", "pos"], into=s) == ["pos"]
    assert s["k"] == 3
    assert isinstance(tconfig.svar, tconfig.Svar)


# ---------------------------------------------------------------------------
# Messenger


def bus_sync(mod):
    bus = mod.Messenger()
    got = []
    bus.subscribe("frames", 0, got.append)
    n = bus.advertise("frames").publish({"id": 1})
    payload = object()
    bus.subscribe("t", 0, got.append)
    bus.publish("t", payload)
    return [n, got[0], got[1] is payload, bus.topics()]


def bus_queued(mod):
    bus = mod.Messenger()
    got = []
    done = threading.Event()

    def cb(m):
        got.append(m)
        if len(got) == 5:
            done.set()

    sub = bus.subscribe("q", 10, cb)
    pub = bus.advertise("q")
    for i in range(5):
        pub.publish(i)
    assert done.wait(5.0)
    n_subs = pub.get_num_subscribers()
    sub.shutdown()
    return [got, n_subs, pub.get_num_subscribers()]


def bus_drops_oldest(mod):
    """A worker held in its first callback while 20 more messages come:
    a queue of 2 keeps the last two."""
    bus = mod.Messenger()
    got = []
    entered, release = threading.Event(), threading.Event()

    def cb(m):
        if not got:
            entered.set()
            release.wait(5.0)
        got.append(m)

    sub = bus.subscribe("q", 2, cb)
    bus.publish("q", 0)
    assert entered.wait(5.0)
    for i in range(1, 21):
        bus.publish("q", i)
    release.set()
    deadline = threading.Event()
    for _ in range(500):
        if len(got) == 3:
            break
        deadline.wait(0.01)
    sub.shutdown()
    return [got]


def bus_unsubscribe(mod):
    bus = mod.Messenger()
    got = []
    sub = bus.subscribe("x", 0, got.append)
    keep = bus.subscribe("x", 0, got.append)
    sub.shutdown()
    n = bus.publish("x", 1)
    bus.shutdown()
    return [n, got, bus.publish("x", 2), got, bus.topics(), keep.topic]


@pytest.mark.parametrize("case", [bus_sync, bus_queued, bus_drops_oldest,
                                  bus_unsubscribe],
                         ids=lambda c: c.__name__)
def test_messenger_same_as_reference(case):
    assert case(tmessenger) == case(jmessenger)


def test_flush_waits_for_the_callback_in_flight():
    bus = tmessenger.Messenger()
    got = []
    entered = threading.Event()

    def slow(m):
        entered.set()
        threading.Event().wait(0.2)
        got.append(m)

    sub = bus.subscribe("q", 4, slow)
    bus.publish("q", "a")
    assert entered.wait(5.0)
    sub.flush(timeout=5.0)
    assert got == ["a"]
    sub.shutdown()


def test_a_failed_callback_stops_the_subscriber_and_flush_raises():
    """The reference prints a queued callback's exception and delivers
    the next message; the port keeps it, delivers nothing more, and
    raises it from flush."""
    bus = tmessenger.Messenger()
    got = []

    def cb(m):
        if m == 1:
            raise ValueError("bad message 1")
        got.append(m)

    sub = bus.subscribe("q", 8, cb)
    for i in range(4):
        bus.publish("q", i)
    with pytest.raises(ValueError, match="bad message 1"):
        sub.flush(timeout=5.0)
    assert isinstance(sub.error, ValueError)
    bus.publish("q", 9)
    with pytest.raises(ValueError):
        sub.flush(timeout=0.5)
    sub.shutdown()
    assert got == [0]


# ---------------------------------------------------------------------------
# metrics, timer


def rows():
    rng = np.random.default_rng(0)
    return [dict(frame=i, track_ms=float(rng.uniform(5, 50)),
                 n_matches=int(rng.integers(50, 300)), note="x",
                 ok=bool(i % 2)) for i in range(12)]


def test_metrics_summary_same_as_reference(tmp_path):
    sj, st = JMetrics(), tmetrics.MetricsRegistry(
        stream=open(tmp_path / "m.jsonl", "w"))
    for r in rows():
        sj.emit(**r)
        st.emit(**r)
    st.close()
    assert st.summary() == sj.summary()
    assert st.column("n_matches") == sj.column("n_matches")
    lines = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert [{k: v for k, v in x.items() if k != "t"} for x in lines] \
        == rows()


def test_device_memory_stats_on_the_cpu_is_empty():
    assert tmetrics.device_memory_stats("cpu") == {}
    assert tmetrics.host_rss_bytes() > 0
    assert tmetrics.cpu_percent() >= 0.0


def test_timer_merged_and_dump(capsys):
    a, b = Timer(), Timer()
    with a.section("app/frame"):
        pass
    with b.section("slam/extract"):
        pass
    with b.section("slam/extract"):
        pass
    m = Timer.merged(a, b)
    assert set(m.stats()) == {"app/frame", "slam/extract"}
    assert m.stats()["slam/extract"]["count"] == 2
    with m.section("app/frame"):       # a copy: the sources stay as they are
        pass
    assert a.stats()["app/frame"]["count"] == 1
    m.dump()
    assert "slam/extract" in capsys.readouterr().out
    assert isinstance(timer, Timer)


# ---------------------------------------------------------------------------
# viewer


def viewer_inputs():
    rng = np.random.default_rng(3)
    traj = np.cumsum(rng.normal(0, 0.1, (20, 3)), 0)
    q = rng.normal(size=(3, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kf = np.concatenate([rng.normal(size=(3, 3)), q,
                         rng.uniform(0.5, 2, (3, 1))], 1)
    return dict(traj=traj, gt=traj + 0.01,
                points=rng.normal(0, 1, (100, 3)),
                point_colors=rng.uniform(0, 1, (100, 3)),
                kf_poses=list(kf) + [np.array([1.0, 2, 3, 1, 0, 0, 0])],
                covis=rng.normal(size=(8, 3)))


@pytest.mark.parametrize("refresh_s", [0.0, 2.0])
def test_export_html_byte_identical(tmp_path, refresh_s):
    kw = viewer_inputs()
    pj = jwebviz.export_html(str(tmp_path / "j.html"), title="run · x",
                             refresh_s=refresh_s, **kw)
    pt = twebviz.export_html(str(tmp_path / "t.html"), title="run · x",
                             refresh_s=refresh_s, **kw)
    tj, tt = open(pj, "rb").read(), open(pt, "rb").read()
    assert tt == tj
    txt = tt.decode()
    assert "<canvas" in txt and "http://" not in txt
    data = json.loads(txt.split("const D = ", 1)[1].split(";\n", 1)[0])
    assert len(data["traj"]) == 20 and len(data["frusta"]) == 4


def test_frustum_segments_same_as_reference():
    for pose in viewer_inputs()["kf_poses"]:
        np.testing.assert_array_equal(twebviz.frustum_segments(pose),
                                      jwebviz.frustum_segments(pose))
    pose = np.array([1.0, 2.0, 3.0, 1.0, 0, 0, 0])
    segs = twebviz.frustum_segments(pose)
    assert segs.shape == (16, 3)
    np.testing.assert_allclose(segs[0], pose[:3])


@pytest.fixture(scope="module")
def run():
    """A port run on the CPU (12 frames, 192x144) and its arena carried
    into the JAX package through numpy."""
    ds = SyntheticDataset(n_frames=12, n_points=300, width=192, height=144,
                          motion="line", depth=True)
    ds.open("synth://")
    frames = list(ds)
    slam = KeyframeSLAM(ds.camera, SLAMConfig(
        max_kps=192, fast_threshold=0.1, ba_window=4, ba_points=256,
        ba_iters=3, cap_frames=32, cap_points=2048, cap_obs=8192,
        local_map_size=384, kf_max_gap=3), device="cpu")
    for fr in frames:
        slam.track(fr)
    a = slam.arena
    arena_j = ja.make_arena(a.cap_frames, a.cap_kps, a.cap_points,
                            a.cap_obs).replace(
        **{k: jnp.asarray(v) for k, v in arena_to_numpy(a).items()})
    return slam, arena_j, frames


@pytest.mark.parametrize("min_common,max_edges", [(15, 400), (1, 3)])
def test_covis_segments_same_as_reference(run, min_common, max_edges):
    slam, arena_j, _ = run
    assert int(slam.arena.n_frames) >= 3
    got = twebviz.covis_segments(slam.arena, min_common, max_edges)
    want = jwebviz.covis_segments(arena_j, min_common, max_edges)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)


def test_export_run_html_same_as_reference(run, tmp_path):
    slam, arena_j, frames = run
    gt = np.stack([f.gt_pose[:3] for f in frames])
    like = types.SimpleNamespace(positions=slam.positions, arena=arena_j)
    pj = jwebviz.export_run_html(str(tmp_path / "j.html"), like, gt=gt,
                                 title="t", refresh_s=2.0)
    pt = twebviz.export_run_html(str(tmp_path / "t.html"), slam, gt=gt,
                                 title="t", refresh_s=2.0)
    assert open(pt, "rb").read() == open(pj, "rb").read()


def test_overview_png(run, tmp_path):
    slam, _, frames = run
    gt = np.stack([f.gt_pose[:3] for f in frames])
    pts = slam.arena.point_xyz[slam.arena.point_valid].numpy()
    path = twebviz.overview_png(str(tmp_path / "o.png"), slam.positions(),
                                gt=gt, points=pts)
    from PIL import Image

    img = np.asarray(Image.open(path))
    assert img.shape == (720, 960, 3)
    # the estimate (blue), the ground truth (green) and the map (grey)
    for color in ((30, 90, 220), (40, 170, 80), (150, 150, 150)):
        assert (img == color).all(-1).sum() > 20, color


def test_png_writer_round_trip(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for arr in (rng.integers(0, 256, (7, 5, 3), dtype=np.uint8),
                rng.integers(0, 65536, (4, 9), dtype=np.uint16),
                rng.integers(0, 256, (3, 3), dtype=np.uint8)):
        write_png(tmp_path / "x.png", arr)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path /
                                                            "x.png")), arr)


# ---------------------------------------------------------------------------
# report


def test_eval_report_same_keys_and_trajectory_fields(run):
    slam, _, frames = run
    t = np.asarray([f.timestamp for f in frames])
    gt = np.stack([f.gt_pose[:3] for f in frames])
    pos = slam.positions()
    extra = {"frames": len(frames), "keyframes": int(slam.arena.n_frames)}
    dj = JReport("seq", j_eval(t, pos, t, gt, with_scale=False),
                 extra=extra).to_dict()
    rep = EvalReport("seq", evaluate_trajectory(t, pos, t, gt,
                                                with_scale=False),
                     timer=Timer.merged(timer, slam.timer), extra=extra,
                     device="cpu")
    dt = rep.to_dict()
    assert set(dt) == set(dj)
    for k in ("sequence", "ate_rmse", "rpe_rmse", "rpe_mean", "n_matched",
              "scale", "frames", "keyframes"):
        assert dt[k] == dj[k], k
    assert dt["device_hbm_mb"] == 0.0
    assert "slam/track_fused" in dt["timing"]
    assert json.loads(rep.json())["ate_rmse"] == dj["ate_rmse"]
    assert "ATE RMSE" in rep.table()
