"""The port's CLI (gslam_tpu_torch.app.cli) with ``-cpu true`` against the
JAX package's CLI and against the port's own direct loop.

* tests/test_app.py:203-317 re-run with the port: ``viz`` writes the
  HTML viewer (its embedded JSON parses), both PLYs and the PNG;
  ``play -viz.live 1`` re-emits the viewer during the run and turns its
  reload off at the end; ``-metrics`` writes a row a frame with the
  system's stats and ``-profile`` a Chrome trace; ``-vocabulary`` reads
  a vocabulary saved by the JAX package (npz, DBoW3 text, flat binary),
  ``-save_map`` writes a map that the JAX package's ``load_arena`` and
  the port's read, and ``-load_map`` resumes on it.
* tests/test_loaders_play_e2e.py:150-171: ``play`` over the TUM RGB-D,
  KITTI (stereo) and EuRoC fixtures tracks as many frames in the port
  as in the JAX package, with features on every frame.
* ``eval`` on a 10-frame 192x144 synthetic sequence: the port's saved
  trajectory is bit for bit (the same text) its direct ``track`` loop's
  with the same configuration and seed, and its ATE within ``max(0.05,
  2 ref + 0.01)`` of the JAX CLI's ``ref``.  The JAX package's RANSAC
  draws come from a JAX key chain inside its CLI run, which the CLI
  cannot hand to the port, so the two runs take different draws: hence
  the ATE gate across packages and bit equality within the port.
* ``-debug true`` raises at an injected non-finite keyframe pose, naming
  the frame, and passes a clean run; ``-debug.nojit true`` on a batched
  run (``dispatch_batch`` 4) gives the eager run's trajectory and turns
  the batch graph off.
* ``bench`` and ``tests`` exist; ``tests`` runs pytest in a subprocess;
  without a card, ``bench`` and the card's ``tests`` raise.

The JAX CLI runs once per module (module-scoped fixtures).  ``python
tests/test_torch_cli.py --replay-reference-tum`` runs the TUM cell's
check against the JAX package with its draws replayed (ROADMAP Queue C).
"""

import json
import os

import numpy as np
import pytest
import torch

from gslam_tpu_torch.app import cli
from gslam_tpu_torch.app.config import Svar
from gslam_tpu_torch.app.registry import open_dataset
from gslam_tpu_torch.eval.trajectory import save_tum_trajectory
from gslam_tpu_torch.map.arena import load_arena
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.utils.timer import timer

torch.set_num_threads(2)

SMALL = ["-slam.max_kps", "128", "-slam.cap_points", "1024",
         "-slam.cap_obs", "4096"]
LOADER_FLAGS = ["-slam.max_kps", "128", "-slam.cap_points", "1024",
                "-slam.cap_obs", "4096", "-slam.cap_frames", "16",
                "-slam.local_map_size", "256", "-slam.ba_points", "128",
                "-slam.ba_iters", "2"]
EVAL_SEQ = {"n_frames": 10, "n_points": 350, "width": 192, "height": 144,
            "motion": "line", "depth": True}
EVAL_CFG = dict(max_kps=192, fast_threshold=0.1, kf_max_gap=4)
EVAL_FLAGS = ["-slam.max_kps", "192", "-slam.fast_threshold", "0.1",
              "-slam.kf_max_gap", "4"]


def synth(tmp_path, name="seq.synth", **kw):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(json.dumps(kw or {"n_frames": 5, "n_points": 200,
                                  "width": 160, "height": 120}))
    return path


def run_app(app, argv):
    s = Svar()
    s.parse_main([app, "-cpu", "true", *argv])
    return {"play": cli.app_play, "eval": cli.app_eval,
            "viz": cli.app_viz}[app](s)


# ---------------------------------------------------------------------------
# tests/test_app.py:203-317 with the port


def test_viz_app_writes_outputs(tmp_path):
    out = str(tmp_path / "run")
    assert run_app("viz", ["-dataset", synth(tmp_path), "-slam", "keyframe",
                           "-out", out, *SMALL]) == 0
    for suffix in (".html", "_traj.ply", "_map.ply", ".png"):
        assert os.path.exists(out + suffix), suffix
    txt = open(out + ".html").read()
    data = json.loads(txt.split("const D = ", 1)[1].split(";\n", 1)[0])
    assert len(data["traj"]) == 5 and len(data["points"]) > 20
    assert len(data["frusta"]) >= 1
    ply = open(out + "_traj.ply").read().splitlines()
    assert "element vertex 5" in ply and len(ply) == 7 + 5
    assert open(out + ".png", "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_viz_without_out_writes_into_the_working_directory(tmp_path,
                                                           monkeypatch):
    """Without -out the outputs go to ``gslam_viz.*`` in the working
    directory (the reference's default is a fixed /tmp prefix)."""
    monkeypatch.chdir(tmp_path)
    assert run_app("viz", ["-dataset", synth(tmp_path), "-slam", "keyframe",
                           *SMALL]) == 0
    for suffix in (".html", "_traj.ply", "_map.ply", ".png"):
        assert (tmp_path / ("gslam_viz" + suffix)).exists(), suffix


def test_play_viz_live_reemits(tmp_path):
    out = str(tmp_path / "live")
    path = synth(tmp_path, n_frames=8, n_points=200, width=160, height=120,
                 depth=True)
    assert run_app("play", ["-dataset", path, "-slam", "keyframe",
                            "-out", out, "-viz.live", "1", *SMALL]) == 0
    txt = open(out + ".html").read()
    assert "REFRESH_S = 0.0" in txt
    assert "location.reload" in txt
    assert timer.stats().get("app/viz_live", None) is not None


def test_play_metrics_and_profile(tmp_path):
    mpath = str(tmp_path / "m.jsonl")
    pdir = str(tmp_path / "trace")
    path = synth(tmp_path, n_frames=4, n_points=200, width=160, height=120)
    assert run_app("play", ["-dataset", path, "-slam", "keyframe",
                            "-metrics", mpath, "-profile", pdir,
                            *SMALL]) == 0
    rows = [json.loads(ln) for ln in open(mpath)]
    assert len(rows) == 4
    assert all("track_ms" in r and "frame" in r for r in rows)
    assert rows[-1].get("n_inliers", 0) >= 1
    trace = os.path.join(pdir, "trace.json")
    assert os.path.isfile(trace)
    events = json.load(open(trace))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


@pytest.fixture(scope="module")
def jax_vocabulary_files(tmp_path_factory):
    """A vocabulary trained and saved by the JAX package, in its three
    formats."""
    from gslam_tpu.ops import vocab as jv

    rng = np.random.default_rng(0)
    voc = jv.train_vocabulary(
        rng.integers(0, 2**32, (200, 8), dtype=np.uint64)
        .astype(np.uint32), k=3, L=2, seed=0)
    d = tmp_path_factory.mktemp("voc")
    paths = {"npz": str(d / "voc.npz"), "txt": str(d / "voc.txt"),
             "bin": str(d / "voc.gvoc")}
    jv.save_vocabulary(voc, paths["npz"])
    jv.save_dbow3_text(voc, paths["txt"])
    jv.save_binary(voc, paths["bin"])
    return paths


@pytest.mark.parametrize("fmt", ["npz", "txt", "bin"])
def test_vocabulary_flag_and_save_map(tmp_path, jax_vocabulary_files, fmt):
    from gslam_tpu.map.arena import load_arena as j_load_arena

    mpath = str(tmp_path / "map.npz")
    path = synth(tmp_path)
    assert run_app("play", ["-dataset", path, "-slam", "keyframe",
                            "-vocabulary", jax_vocabulary_files[fmt],
                            "-save_map", mpath, *SMALL]) == 0
    arena = load_arena(mpath, device="cpu")
    assert int(arena.n_frames) >= 1
    assert int(arena.point_valid.sum()) > 20
    # the layout is shared: the JAX package reads the port's map
    arena_j = j_load_arena(mpath)
    assert int(arena_j.n_frames) == int(arena.n_frames)
    np.testing.assert_array_equal(np.asarray(arena_j.point_xyz),
                                  arena.point_xyz.numpy())
    # and the port resumes on it
    s = Svar()
    s.parse_main(["play", "-cpu", "true", "-dataset", path, "-slam",
                  "keyframe", "-load_map", mpath, *SMALL])
    ds = open_dataset(path)
    slam = cli._build_slam(ds, s, torch.device("cpu"))
    assert slam.initialized and slam.last_kf_id == int(arena.n_frames) - 1


# ---------------------------------------------------------------------------
# tests/test_loaders_play_e2e.py:150-171 in both packages


LOADERS = {"tum": ("build_tum", {}, []),
           "kitti": ("build_kitti", dict(stereo=True), ["-slam", "stereo"]),
           "euroc": ("build_euroc", dict(stereo=True, imu=True), [])}


@pytest.fixture(scope="module")
def loader_fixtures(tmp_path_factory):
    """Each fixture written as the reference test writes it, and the JAX
    package's ``play`` over it: (path, extra flags, the JAX rows)."""
    from gslam_tpu.app import cli as jcli
    from gslam_tpu.app.config import Svar as JSvar
    from tests import test_loaders_play_e2e as e2e

    out = {}
    for name, (write, render_kw, extra) in LOADERS.items():
        d = tmp_path_factory.mktemp(name)
        frames, cam = e2e._render(**render_kw)
        path = getattr(e2e, write)(d / "seq", frames, cam)
        mpath = str(d / "jax.jsonl")
        s = JSvar()
        s.parse_main(["play", "-dataset", path, "-slam", "keyframe",
                      "-metrics", mpath, *LOADER_FLAGS, *extra])
        assert jcli.app_play(s) == 0
        out[name] = (path, extra, [json.loads(x) for x in open(mpath)],
                     len(frames))
    return out


@pytest.mark.parametrize("name", list(LOADERS))
def test_play_decodes_fixtures_like_reference(loader_fixtures, tmp_path,
                                              name):
    path, extra, rows_j, n = loader_fixtures[name]
    mpath = str(tmp_path / "port.jsonl")
    assert run_app("play", ["-dataset", path, "-slam", "keyframe",
                            "-metrics", mpath, *LOADER_FLAGS,
                            *extra]) == 0
    rows = [json.loads(x) for x in open(mpath)]
    assert len(rows) == len(rows_j) == n
    assert [r["frame"] for r in rows] == [r["frame"] for r in rows_j]
    assert all(r.get("n_features", 0) > 20 for r in rows)


# ---------------------------------------------------------------------------
# eval: the port's CLI against its direct loop and the JAX CLI


@pytest.fixture(scope="module")
def eval_reference(tmp_path_factory):
    """The JAX CLI's eval over the 10-frame sequence: its ATE."""
    from gslam_tpu.app import cli as jcli
    from gslam_tpu.app.config import Svar as JSvar

    d = tmp_path_factory.mktemp("eval")
    path = synth(d, **EVAL_SEQ)
    s = JSvar()
    s.parse_main(["eval", "-dataset", path, "-slam", "keyframe",
                  "-out", str(d / "jax.json"), *EVAL_FLAGS])
    assert jcli.app_eval(s) == 0
    return path, json.load(open(d / "jax.json"))


def test_eval_trajectory_bit_for_bit_the_direct_loop(eval_reference,
                                                     tmp_path):
    path, rep_j = eval_reference
    traj, rep = str(tmp_path / "t.txt"), str(tmp_path / "r.json")
    kitti = str(tmp_path / "t.kitti")
    assert run_app("eval", ["-dataset", path, "-slam", "keyframe",
                            "-out", rep, "-save_traj", traj,
                            *EVAL_FLAGS]) == 0
    ds = open_dataset(path)
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**EVAL_CFG), device="cpu")
    ts = []
    for fr in ds:
        slam.track(fr)
        ts.append(fr.timestamp)
    direct = str(tmp_path / "direct.txt")
    save_tum_trajectory(direct, np.asarray(ts),
                        torch.stack(slam.trajectory)[:, :7].numpy())
    assert open(traj).read() == open(direct).read()
    d = json.load(open(rep))
    assert set(d) == set(rep_j)
    assert d["frames"] == rep_j["frames"] == 10
    ref = rep_j["ate_rmse"]
    gate = max(0.05, 2 * ref + 0.01)
    assert d["ate_rmse"] <= gate, (d["ate_rmse"], ref)
    assert "app/frame" in d["timing"] and "slam/extract" in d["timing"]
    # the KITTI writer and the frame window
    assert run_app("eval", ["-dataset", path, "-slam", "keyframe",
                            "-save_traj", kitti, "-Dataset.Skip", "2",
                            "-Dataset.Max", "5", "-eval.sim3", "true",
                            *EVAL_FLAGS]) == 0
    assert len(open(kitti).read().splitlines()) == 5


# ---------------------------------------------------------------------------
# -debug, -debug.nojit


def test_debug_raises_on_an_injected_nan(tmp_path, monkeypatch):
    path = synth(tmp_path, n_frames=6, n_points=200, width=160, height=120,
                 depth=True)
    argv = ["-dataset", path, "-slam", "keyframe", *SMALL]
    debug = ["-debug", "true"]
    assert run_app("play", argv + debug) == 0          # a clean run passes
    track = KeyframeSLAM.track

    def poisoned(self, frame):
        out = track(self, frame)
        if frame.id == 3:
            fp = self.arena.frame_pose.clone()
            fp[0, 0] = float("nan")
            self.arena = self.arena.replace(frame_pose=fp)
        return out

    monkeypatch.setattr(KeyframeSLAM, "track", poisoned)
    with pytest.raises(FloatingPointError, match="after frame 3"):
        run_app("play", argv + debug)
    # without -debug the run carries on
    assert run_app("play", argv) == 0


def test_debug_nojit_batched_equals_the_eager_run(tmp_path):
    path = synth(tmp_path, n_frames=12, n_points=300, width=192,
                 height=144, motion="line", depth=True)
    flags = ["-slam.max_kps", "192", "-slam.fast_threshold", "0.1",
             "-slam.dispatch_batch", "4"]
    traj = str(tmp_path / "t.txt")
    assert run_app("play", ["-dataset", path, "-slam", "keyframe",
                            "-debug.nojit", "true", "-save_traj", traj,
                            *flags]) == 0
    ds = open_dataset(path)
    frames = list(ds)
    slam = KeyframeSLAM(ds.camera, SLAMConfig(
        max_kps=192, fast_threshold=0.1, dispatch_batch=4), device="cpu")
    for i in range(0, len(frames), 4):       # the CLI's buffers of K
        slam.track_batch(frames[i:i + 4])
    assert sum(slam.batch_accepted) > 0
    direct = str(tmp_path / "eager.txt")
    save_tum_trajectory(direct, np.asarray([f.timestamp for f in frames]),
                        torch.stack(slam.trajectory)[:, :7].numpy())
    assert open(traj).read() == open(direct).read()
    for nojit, graphs in (("true", False), ("false", True)):
        s = Svar()
        s.parse_main(["play", "-dataset", path, "-slam", "keyframe",
                      "-debug.nojit", nojit, *flags])
        assert cli._build_slam(ds, s, torch.device("cpu")).use_graphs \
            is graphs


# ---------------------------------------------------------------------------
# bench, tests, main


def test_tests_app_runs_pytest_in_a_subprocess(monkeypatch):
    calls = []

    class Done:
        returncode = 0

    monkeypatch.setattr(cli.subprocess, "run",
                        lambda cmd, **kw: calls.append((cmd, kw)) or Done())
    s = Svar()
    s.parse_main(["tests", "-cpu", "true"])
    assert cli.app_tests(s) == 0
    cmd, kw = calls[0]
    assert cmd[1:3] == ["-m", "pytest"] and "--noconftest" not in cmd
    files = [os.path.basename(c) for c in cmd if c.endswith(".py")]
    assert "test_torch_cli.py" in files and "test_app.py" not in files
    assert all(f.startswith("test_torch_") for f in files)
    assert kw["cwd"] == cli.REPO_ROOT
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            cli.app_tests(Svar())
        with pytest.raises(RuntimeError, match="is_available"):
            cli.app_bench(Svar())
        with pytest.raises(RuntimeError, match="is_available"):
            run_app_on_card = Svar()
            run_app_on_card.parse_main(["play", "-dataset", "x.synth"])
            cli.app_play(run_app_on_card)


def test_main_without_an_app_prints_the_apps(capsys):
    assert cli.main([]) == 1
    assert "apps:" in capsys.readouterr().out
    assert cli.main(["nope"]) == 1
    assert sorted(cli.APPS.names()) == ["bench", "eval", "play", "tests",
                                        "viz"]


# ---------------------------------------------------------------------------
# the TUM cell's ATE against the JAX package's, draws replayed (a run, not a
# test: PYTHONPATH=. python tests/test_torch_cli.py --replay-reference-tum)


def replay_reference_tum(n_frames: int = 64) -> dict:
    """The TUM-layout cell (tests/test_torch_slam.py::reference_tum_run's
    files, which ``eval`` reads on the card in chip_smoke.py) through the
    JAX package's KeyframeSLAM with its RANSAC draws recorded in the
    order it takes them, then through the port's on the CPU, read by the
    port's own open_dataset, once with those draws replayed and once
    with its own generator: ATE, keyframes and the inlier count of every
    frame of each, and the first frame where each run's inliers leave
    the JAX run's.  ``frontend``: both packages' extraction
    (DISTORTED_CFG's budget and threshold, the port's plain path) on the
    first four decoded frames: keypoints equal, the largest angle
    difference, and the descriptors and bits that differ."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from chip_smoke import write_tum_sequence
    from gslam_tpu.app.registry import open_dataset as j_open
    from gslam_tpu_torch import convert
    from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
    from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
    from gslam_tpu_torch.ops import frontend as tfrontend
    from tests.test_torch_slam import (DISTORTED_CFG, TUM_SEQUENCE, JConfig,
                                       JSLAM, j_eval, j_extract, run)

    src = SyntheticDataset(**dict(TUM_SEQUENCE, n_frames=n_frames))
    src.open("synth://")
    with tempfile.TemporaryDirectory() as tmp:
        root = tmp + "/synth_distorted"
        write_tum_sequence(root, list(src), src.camera)
        dj = j_open(root + ".tumrgbd")
        jframes = list(dj)
        dt = open_dataset(root + ".tumrgbd")
        tframes = list(dt)
    frontend = []
    for fj, ft in zip(jframes[:4], tframes[:4]):
        a = j_extract(jnp.asarray(fj.image), max_kps=DISTORTED_CFG["max_kps"],
                      threshold=DISTORTED_CFG["fast_threshold"])
        b = convert.features_to_numpy(tfrontend.extract_features(
            torch.as_tensor(ft.image), max_kps=DISTORTED_CFG["max_kps"],
            threshold=DISTORTED_CFG["fast_threshold"], use_kernels=False))
        da = np.asarray(a.desc).view(np.uint32)
        bits = np.unpackbits((da ^ b["desc"]).view(np.uint8), axis=1).sum(1)
        frontend.append(dict(
            same_image=bool(np.array_equal(fj.image, ft.image)),
            same_keypoints=bool(np.array_equal(np.asarray(a.uv), b["uv"])
                                and np.array_equal(np.asarray(a.valid),
                                                   b["valid"])),
            angle_max_diff=float(np.abs(np.asarray(a.angle)
                                        - b["angle"]).max()),
            desc_rows_differing=int((bits > 0).sum()),
            bits_differing=int(bits.sum()), bits=int(da.size * 32),
            most_bits_in_a_row=int(bits.max())))
    js = JSLAM(dj.camera, JConfig(**DISTORTED_CFG))
    keys = []
    next_key = js._next_key

    def recorded_key():
        keys.append(next_key())
        return keys[-1]

    js._next_key = recorded_key
    t, gt = run(js, jframes)
    out = dict(frontend=frontend, jax=dict(
        ate_m=float(j_eval(t, js.positions(), t, gt,
                           with_scale=False).ate_rmse),
        keyframes=js._n_frames_host, draws=len(keys),
        inliers=[s["n_inliers"] for s in js.stats]))
    draws = iter([torch.tensor(np.asarray(jax.random.uniform(k, (256, 4))))
                  for k in keys])
    for name, hook in (("replayed", lambda: next(draws)), ("own", None)):
        ts = KeyframeSLAM(dt.camera, SLAMConfig(**DISTORTED_CFG),
                          device="cpu", uniforms=hook)
        run(ts, tframes)
        inl = [s["n_inliers"] for s in ts.stats]
        out[name] = dict(
            ate_m=float(evaluate_trajectory(t, ts.positions(), t, gt,
                                            with_scale=False).ate_rmse),
            keyframes=ts._n_frames_host, inliers=inl,
            first_inlier_gap=next((i for i, (a, b) in enumerate(
                zip(inl, out["jax"]["inliers"])) if a != b), None))
    return out


if __name__ == "__main__":
    import sys

    if sys.argv[1:] != ["--replay-reference-tum"]:
        sys.exit("usage: python tests/test_torch_cli.py "
                 "--replay-reference-tum")
    import jax

    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    print(json.dumps(replay_reference_tum()))
