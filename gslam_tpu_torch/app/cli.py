"""CLI: the ``gslam`` binary analog, on PyTorch and the CUDA card.

Counterpart of ``gslam_tpu/app/cli.py``, with the same apps and flags
(``gslam <app> -dataset <path> [svar args]``, Svar-registered apps):

    python -m gslam_tpu_torch play  -dataset seq.synth -slam keyframe
    python -m gslam_tpu_torch eval  -dataset seq.synth -slam keyframe
    python -m gslam_tpu_torch viz   -dataset seq.synth -out /tmp/run
    python -m gslam_tpu_torch bench
    python -m gslam_tpu_torch tests

Every app runs on the CUDA card; ``-cpu true`` runs it on the CPU (the
kernels' plain versions).  Without a card and without ``-cpu true`` an
app raises: nothing falls back to the CPU.  ``viz`` is the headless
counterpart of the reference's Qt viewer: trajectory and map export
(PLY, PNG, a self-contained HTML viewer).

Where the reference leans on JAX: ``-profile DIR`` records
``torch.profiler`` (CPU and, on the card, CUDA activity) and writes a
Chrome trace into DIR.  While it records, each timer span of the app and
of the system (``utils/timer.py``) opens a range of its name in the
trace, ``frame=<id>`` its args, beside the kernels it queued, and on the
card also times itself with a pair of CUDA events (``<span>:device`` in
the report's timing); with no ``-profile`` a span reads only the host
clock.  ``-debug true`` fails at the first non-finite
value in what a frame's step returns or in the map's keyframe poses
after it, naming the frame (the intended NaN of a masked singular solve
inside a step is not an output); ``-debug.nojit true`` runs
``track_batch``'s K-frame body and ``track``'s extraction and PnP
RANSAC + GN refine eagerly instead of as their CUDA graphs.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import time
from typing import List

import numpy as np
import torch

from gslam_tpu_torch.app.config import Svar, svar
from gslam_tpu_torch.app.registry import APPS, SLAMS, open_dataset
from gslam_tpu_torch.utils.logging import get_logger
from gslam_tpu_torch.utils.platform import require_device
from gslam_tpu_torch.utils.timer import Timer, timer

log = get_logger("gslam_tpu_torch.cli")

#: the repository root (tests/ and chip_smoke.py live there)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _device(s: Svar) -> torch.device:
    """-cpu true: the CPU; otherwise the card, which must be present."""
    cpu = s.arg("cpu", False, "run on the CPU (the kernels' plain versions)")
    return require_device("cpu" if cpu else "cuda")


def _build_slam(dataset, s: Svar, device: torch.device):
    import gslam_tpu_torch.models  # noqa: F401  (fills SLAMS)

    name = s.arg("slam", "keyframe", "SLAM system (registry name)")
    # every -slam.<field> flag goes to the system's config (unknown
    # fields fail loudly in the config rather than being dropped)
    kwargs = dict(s.subtree("slam"))
    # -vocabulary voc.npz | DBoW3 text (.txt) | flat binary (.voc /
    # .gvoc): BoW loop closure and relocalization
    voc_path = s.arg("vocabulary", "",
                     "BoW vocabulary (npz / DBoW3 text / binary)")
    if voc_path:
        from gslam_tpu_torch.ops.vocab import (load_binary, load_dbow3_text,
                                               load_vocabulary)

        load = (load_dbow3_text if voc_path.endswith(".txt")
                else load_vocabulary if voc_path.endswith(".npz")
                else load_binary)
        kwargs["vocabulary"] = load(voc_path, device=device)
    slam = SLAMS.create(name, dataset.camera, device=device, **kwargs)
    # -load_map: resume / localize on a prebuilt arena (Map::load)
    load_map = s.arg("load_map", "", "resume from a map arena (npz)")
    if load_map and hasattr(slam, "load_map"):
        slam.load_map(load_map)
        log.info("loaded map arena from %s", load_map)
    # -debug.nojit true: the K-frame body and track's extraction and PnP
    # eagerly, not as CUDA graphs
    if s.arg("debug.nojit", False,
             "run track_batch's body and track's extraction and PnP "
             "eagerly") \
            and hasattr(slam, "track_batch"):
        slam.use_graphs = False
    return slam


def _check_finite(slam, step_out, frame_id) -> None:
    """-debug: raise at the first non-finite value in a step's outputs
    or in the map's valid keyframe poses after it."""
    outs = step_out if isinstance(step_out, list) else [step_out]
    for i, t in enumerate(outs):
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"-debug: non-finite pose returned at frame {frame_id}"
                + (f" (entry {i} of the batch)" if len(outs) > 1 else "")
                + f": {t.cpu().numpy()}")
    arena = getattr(slam, "arena", None)
    if arena is not None:
        poses = arena.frame_pose[arena.frame_valid]
        bad = ~torch.isfinite(poses).all(-1)
        if bool(bad.any()):
            rows = torch.nonzero(arena.frame_valid)[:, 0][bad].tolist()
            raise FloatingPointError(
                f"-debug: non-finite keyframe pose(s) {rows} in the map "
                f"after frame {frame_id}")


class _Profile:
    """-profile DIR: torch.profiler over the run, a Chrome trace into
    DIR at the end.  The timers' spans open their ranges and device
    events only while it records."""

    def __init__(self, out_dir: str, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        log.info("wrote profiler trace to %s", path)


def _run_sequence(s: Svar):
    device = _device(s)
    debug = s.arg("debug", False, "fail loudly on NaN / Inf")
    path = s.arg("dataset", "", "dataset path (extension dispatch)")
    if not path:
        raise SystemExit("need -dataset <path>")
    try:
        ds = open_dataset(path)
    except (OSError, KeyError) as e:
        raise SystemExit(f"could not open dataset {path}: {e}")
    if not ds.is_opened():
        raise SystemExit(f"could not open dataset {path}")
    slam = _build_slam(ds, s, device)
    skip = s.arg("Dataset.Skip", 0, "frames to skip")
    max_frames = s.arg("Dataset.Max", 0, "max frames (0 = all)")
    profile_dir = s.arg("profile", "", "write a torch.profiler trace here, "
                        "each timer span a range beside its kernels")
    # per-frame metrics as streamed JSON lines
    metrics_path = s.arg("metrics", "", "stream per-frame metric JSONL here")
    metrics = None
    if metrics_path:
        from gslam_tpu_torch.utils.metrics import MetricsRegistry

        metrics = MetricsRegistry(stream=open(metrics_path, "w"))
    prof = _Profile(profile_dir, device) if profile_dir else None
    # re-emit the interactive viewer every K keyframes (atomic file
    # replace; the HTML reloads itself, so a browser shows the map grow)
    viz_live = s.arg("viz.live", 0,
                     "re-emit the HTML viewer every K keyframes (0=off)")
    viz_live_path = s.arg("out", "run") + ".html" if viz_live else ""
    last_live_kf = 0
    # batched dispatch (slam.track_batch): this many frames a dispatch
    batch_k = int(getattr(getattr(slam, "cfg", None),
                          "dispatch_batch", 1) or 1)
    batch_k = batch_k if hasattr(slam, "track_batch") else 1
    buf = []
    gts, ts = [], []
    n = 0

    def sync():
        # app/frame and track_ms time finished work on the card
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def flush_batch():
        if not buf:
            return
        n_stats0 = len(getattr(slam, "stats", []))
        t0 = time.perf_counter()
        timer.frame = buf[0][0]
        with timer.section("app/frame"):
            out = slam.track_batch([f for _, f in buf])
            sync()
        ms = 1e3 * (time.perf_counter() - t0) / len(buf)
        if debug:
            _check_finite(slam, out, buf[0][0])
        if metrics is not None:
            rows = getattr(slam, "stats", [])[n_stats0:]
            for (fid, _), row in zip(buf, rows):
                metrics.emit(frame=fid, track_ms=ms, **dict(row))
        buf.clear()

    try:
        for i, fr in enumerate(ds):
            if i < skip:
                continue
            if batch_k > 1:
                buf.append((fr.id, fr))
                if len(buf) >= batch_k:
                    flush_batch()
            else:
                t0 = time.perf_counter()
                timer.frame = fr.id
                with timer.section("app/frame"):
                    out = slam.track(fr)
                    sync()
                track_ms = 1e3 * (time.perf_counter() - t0)
                if debug:
                    _check_finite(slam, out, fr.id)
                if metrics is not None:
                    row = dict(slam.stats[-1]) \
                        if getattr(slam, "stats", None) else {}
                    metrics.emit(frame=fr.id, track_ms=track_ms, **row)
            if fr.gt_pose is not None:
                gts.append(fr.gt_pose[:3])
            ts.append(fr.timestamp)
            if viz_live and getattr(slam, "stats", None):
                n_kf = slam.stats[-1].get("n_kf", 0)
                if n_kf >= last_live_kf + viz_live:
                    from gslam_tpu_torch.app.webviz import export_run_html

                    with timer.section("app/viz_live"):
                        export_run_html(
                            viz_live_path, slam,
                            gt=np.stack(gts) if gts else None,
                            title=f"{path} (live, frame {fr.id})",
                            refresh_s=2.0)
                    last_live_kf = n_kf
            n += 1
            if max_frames and n >= max_frames:
                break
        flush_batch()
    finally:
        if prof is not None:
            prof.stop()
        if metrics is not None:
            metrics.close()
    if viz_live:
        # final emit with the reload timer off so the browser settles
        from gslam_tpu_torch.app.webviz import export_run_html

        export_run_html(viz_live_path, slam,
                        gt=np.stack(gts) if gts else None,
                        title=f"{path} (finished)")
        log.info("live viewer finalized at %s", viz_live_path)
    # Map::save analog: the arena in the npz layout both packages read
    save_map = s.arg("save_map", "", "write the map arena (npz) here")
    if save_map and hasattr(slam, "arena"):
        from gslam_tpu_torch.map.arena import save_arena

        save_arena(slam.arena, save_map)
        log.info("saved map arena to %s", save_map)
    # trajectory export: TUM (.txt: t xyz qxyzw) or KITTI (.kitti: 3x4)
    save_traj = s.arg("save_traj", "",
                      "write trajectory (TUM .txt / .kitti)")
    if save_traj and getattr(slam, "trajectory", None):
        from gslam_tpu_torch.eval.trajectory import (save_kitti_trajectory,
                                                     save_tum_trajectory)

        poses = torch.stack(slam.trajectory)[:, :7].cpu().numpy()
        if save_traj.endswith(".kitti"):
            save_kitti_trajectory(save_traj, poses)
        else:
            save_tum_trajectory(save_traj, np.asarray(ts), poses)
        log.info("saved trajectory to %s", save_traj)
    return ds, slam, np.asarray(ts), (np.stack(gts) if gts else None)


def _timing(slam) -> Timer:
    """The app's sections beside the system's own (``slam/*``)."""
    own = getattr(slam, "timer", None)
    return Timer.merged(timer, *([own] if own is not None else []))


@APPS.register("play")
def app_play(s: Svar) -> int:
    ds, slam, ts, gt = _run_sequence(s)
    log.info("tracked %d frames", len(ts))
    print(_timing(slam).table())
    return 0


@APPS.register("eval")
def app_eval(s: Svar) -> int:
    from gslam_tpu_torch.eval import EvalReport, evaluate_trajectory

    ds, slam, ts, gt = _run_sequence(s)
    traj = None
    if gt is not None and len(gt) == len(ts):
        # the corrected trajectory where the system has one (frames
        # re-based on their reference keyframe's final pose, so loop
        # corrections apply to the whole path)
        pos = (slam.corrected_positions()
               if hasattr(slam, "corrected_positions")
               else slam.positions())
        traj = evaluate_trajectory(
            ts, pos, ts, gt,
            with_scale=bool(s.arg("eval.sim3", False,
                                  "Sim3 (monocular) alignment")))
    rep = EvalReport(s["dataset"], traj, timer=_timing(slam),
                     extra={"frames": len(ts),
                            "keyframes": int(slam.arena.n_frames)
                            if hasattr(slam, "arena") else 0},
                     device=getattr(slam, "device", None))
    print(rep.table())
    out = s.arg("out", "", "write JSON report here")
    if out:
        with open(out, "w") as f:
            f.write(rep.json())
    return 0


def _write_ply(path: str, pts: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


@APPS.register("viz")
def app_viz(s: Svar) -> int:
    """Headless visualization: PLY map + trajectory, PNG overview, HTML
    viewer."""
    from gslam_tpu_torch.app.webviz import export_run_html, overview_png

    ds, slam, ts, gt = _run_sequence(s)
    # the reference's default is /tmp/gslam_viz; the port writes beside
    # the working directory, so two runs in two checkouts stay apart
    out = s.arg("out", "gslam_viz", "output prefix")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    pos = slam.positions()
    _write_ply(out + "_traj.ply", pos)
    pts = None
    if hasattr(slam, "arena"):
        ok = slam.arena.point_valid.cpu().numpy()
        pts = slam.arena.point_xyz.cpu().numpy()[ok]
        _write_ply(out + "_map.ply", pts)
    export_run_html(out + ".html", slam, gt=gt,
                    title=f"gslam_tpu · {s['dataset']}")
    log.info("wrote %s.html (interactive viewer)", out)
    overview_png(out + ".png", pos, gt=gt, points=pts)
    log.info("wrote %s.png", out)
    log.info("wrote %s_traj.ply / %s_map.ply", out, out)
    return 0


@APPS.register("bench")
def app_bench(s: Svar) -> int:
    """The port's benchmark line (:mod:`gslam_tpu_torch.bench`; the
    card only)."""
    from gslam_tpu_torch import bench

    bench.main()
    return 0


@APPS.register("tests")
def app_tests(s: Svar) -> int:
    """gtest-runner analog: the port's tests, in a pytest subprocess
    (this process imports no test module).  On the card, the card tests
    (marker ``cuda``; the card machine has no JAX, so no conftest); with
    ``-cpu true``, the gold tests ``tests/test_torch_*.py``, which hold
    the port against the JAX package."""
    cpu = s.arg("cpu", False, "run on the CPU (the kernels' plain versions)")
    if cpu:
        files = sorted(glob.glob(os.path.join(REPO_ROOT, "tests",
                                              "test_torch_*.py")))
        cmd = ["-q", *files]
    else:
        require_device("cuda")
        cmd = ["-q", "--noconftest", "-m", "cuda",
               os.path.join(REPO_ROOT, "tests", "test_torch_kernels.py")]
    return subprocess.run([sys.executable, "-m", "pytest", *cmd],
                          cwd=REPO_ROOT).returncode


def main(argv: List[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional = svar.parse_main(argv)
    if not positional:
        print(__doc__)
        print("apps:", APPS.names())
        return 1
    app = positional[0]
    if app not in APPS:
        print(f"unknown app {app!r}; have {APPS.names()}")
        return 1
    return APPS.create(app, svar)
