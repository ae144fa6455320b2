"""Run one cell of the benchmark once and print its result line.

    python3 -m slambench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``slambench/configs/<config>.json``: sensor, scene, system
settings), its traffic (``slambench/traffic/<traffic>.json``: the entry
the window drives and its parameters) and the metrics; each metric is
read by ``slambench/metrics/<metric>.py``, and each cell's limits on the
numbers that decide ``correct`` are ``slambench/limits/<cell>.json``.
Nothing here names a cell, a configuration or a metric.

Set-up: the kernels are built into the program's build directory inside
the checkout (only a checkout's first run compiles), the configuration's
``draws`` sensor draws of its episode are rendered on the card from its
``scene_seed`` and the run's ``--seed`` and copied to the host once, and
one short episode of the cell's own shapes warms the path.  The window
then drives episodes back to back, a fresh system each, cycling through
the draws, until ``--seconds`` have passed; it closes when the pose that
passes that mark reaches the host.  With
``--trace 1`` the profiler covers the window's first ``TRACE_SECONDS``.
After the window the reference judges every pose that was returned.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_SECONDS = 8.0
# top-level modules that may not be loaded in a run (the JAX package's
# name is a prefix of the port's, so names are compared whole)
BANNED = ("jax", "jaxlib", "flax", "gslam_tpu")
# the kernel caches a library may keep (TORCH_EXTENSIONS_DIR,
# TRITON_CACHE_DIR), at fixed paths inside the checkout; the program's own
# nvcc builds go to gslam_tpu_torch/ops/cuda/_build there
CACHE = ROOT / "_slambench_cache"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def cell_files(bench: dict, workload: str):
    """(cell, configuration, traffic, limits) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    return (cell, load_json("configs", cell["config"]),
            load_json("traffic", cell["traffic"]),
            load_json("limits", workload))


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: with ``trace`` the
    per-layer ones, without it the end-to-end ones, each where its
    ``workloads`` (all cells when absent) takes the cell."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def reader(name: str) -> Callable:
    """``read(run)`` of ``slambench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What one run measured; the metric readers take it."""

    config: dict
    traffic: dict
    device: object
    episode: object                      # the first draw (slambench.scene)
    setup_s: float = 0.0
    window_s: float = 0.0
    frames: int = 0                      # poses on the host in the window
    lost: int = 0
    latencies: List[float] = field(default_factory=list)   # s per frame
    episodes: List[dict] = field(default_factory=list)
    sections: Dict[str, Dict[str, float]] = field(default_factory=dict)
    trace: object = None                 # slambench.trace.TraceData
    records: Dict[str, list] = field(default_factory=dict)
    card: str = "not read"
    notes: List[str] = field(default_factory=list)
    check: Dict[str, tuple] = field(default_factory=dict)  # (value, limit)
    correct: bool = False
    # the part of a traced run that the profiler covered, left out of the
    # timer sections' readings: its frames and its sections
    traced_frames: int = 0
    traced_sections: Dict[str, Dict[str, float]] = field(
        default_factory=dict)

    def section(self, name: str):
        """(seconds, calls, frames) of the program's timer section
        ``name`` over the window, less what the profiler covered (where
        frames remain after it), or None where the section never ran."""
        s = self.sections.get(name)
        if not s or not s["count"]:
            return None
        t = self.traced_sections.get(name, {"count": 0, "total": 0.0})
        frames = self.frames - self.traced_frames
        if frames <= 0 or s["count"] <= t["count"]:
            return s["total"], s["count"], self.frames
        return s["total"] - t["total"], s["count"] - t["count"], frames

    def per_frame_ms(self, name: str) -> Optional[float]:
        got = self.section(name)
        return None if got is None else got[0] / got[2] * 1e3


# ----------------------------------------------------------------------
def make_frames(config: dict, episode) -> list:
    """The episode as the program's ``FrameData``, images on the host."""
    from gslam_tpu_torch.core.camera import Camera
    from gslam_tpu_torch.datasets.base import FrameData

    se = config["sensor"]
    cam = Camera.pinhole(se["width"], se["height"], se["fx"], se["fy"],
                         se["cx"], se["cy"])
    stereo = episode.rights is not None
    return [FrameData(
        id=i, timestamp=i / se["rate_hz"], image=episode.images[i],
        camera=cam,
        depth=None if episode.depths is None else episode.depths[i],
        image_right=episode.rights[i] if stereo else None,
        camera_right=cam if stereo else None,
        stereo_baseline=se["baseline"] if stereo else 0.0)
        for i in range(len(episode.images))]


def make_system(config: dict, traffic: dict, camera, seed: int, device):
    """A fresh SLAM system of the configuration, its RANSAC draws seeded
    with ``seed``."""
    import gslam_tpu_torch.models  # noqa: F401  (registers the systems)
    from gslam_tpu_torch.app.registry import SLAMS

    kw = dict(config["slam"], **traffic.get("slam", {}), seed=seed)
    return SLAMS.create(config["system"], camera, device=device, **kw)


def episode_seed(seed: int, k: int) -> int:
    return (seed * 1_000_003 + k) % (1 << 62)


def drive(slam, frames, entry: str, on_pose) -> None:
    """Hand ``frames`` to ``slam`` through ``entry``; ``on_pose(i, pose,
    seconds)`` gets each pose once it is on the host, with the seconds
    from handing the frame in (the dispatch's for a batch); it returns
    True to stop."""
    if entry == "track":
        for i, fr in enumerate(frames):
            a = time.perf_counter()
            pose = slam.track(fr).cpu()
            if on_pose(i, pose, time.perf_counter() - a):
                return
    elif entry == "track_batch":
        import torch
        a = time.perf_counter()
        poses = torch.stack(slam.track_batch(frames)).cpu()
        dt = time.perf_counter() - a
        for i, pose in enumerate(poses):     # all on the host together
            on_pose(i, pose, dt)
    else:
        raise ValueError(f"unknown entry {entry!r}")


def merge_sections(into: Dict[str, Dict[str, float]], timer) -> None:
    for name, s in timer.stats().items():
        acc = into.setdefault(name, {"count": 0, "total": 0.0})
        acc["count"] += s["count"]
        acc["total"] += s["total"]


def lost_frames(slam, n: int) -> int:
    """Frames after the episode's first whose pose PnP did not back."""
    floor = slam.cfg.min_track_inliers
    return sum(1 for s in slam.stats[1:n] if s["n_inliers"] < floor)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: float = T_START) -> Run:
    """Set up, warm and drive the window: the :class:`Run`, its systems
    freed."""
    import torch

    from slambench.scene import World

    dev = torch.device(device)
    if dev.type == "cuda":
        from gslam_tpu_torch.ops.cuda import build
        build.build_all()
    world = World(config["scene"], config["sensor"], dev)
    n_ep = config["episode_frames"]
    draws = [world.episode(n_ep, episode_seed(seed, -1 - j))
             for j in range(config["draws"])]
    del world
    feeds = [make_frames(config, ep) for ep in draws]
    cam = feeds[0][0].camera
    entry = traffic["entry"]
    run = Run(config, traffic, dev, draws[0])

    warm = make_system(config, traffic, cam, episode_seed(seed, 0), dev)
    drive(warm, feeds[0][:traffic["warm_frames"]], entry, lambda *a: False)
    sync(dev)
    del warm
    gc.collect()
    run.setup_s = time.perf_counter() - t_start

    if dev.type == "cuda":
        # the peak reported is the window's own, not the set-up's rendering
        torch.cuda.reset_peak_memory_stats(dev)
    tracer = None
    if trace:
        from slambench.trace import Tracer
        tracer = Tracer(min(TRACE_SECONDS, seconds))
        tracer.start()
    t0 = time.perf_counter()
    stop = False
    k = 0
    while not stop:
        k += 1
        slam = make_system(config, traffic, cam, episode_seed(seed, k), dev)
        poses: List[torch.Tensor] = []

        def end_trace():
            """Stop the profiler once it is due, and mark what it saw."""
            if tracer is None or not tracer.due():
                return
            tracer.stop()
            run.traced_frames = run.frames + len(poses)
            run.traced_sections = {n: dict(v) for n, v in
                                   run.sections.items()}
            merge_sections(run.traced_sections, slam.timer)

        def on_pose(i, pose, dt):
            nonlocal stop
            poses.append(pose)
            run.latencies.append(dt)
            if entry == "track":
                end_trace()
            stop = time.perf_counter() - t0 >= seconds
            return stop

        drive(slam, feeds[(k - 1) % len(feeds)], entry, on_pose)
        end_trace()
        run.window_s = time.perf_counter() - t0
        lost = lost_frames(slam, len(poses))
        run.frames += len(poses)
        run.lost += lost
        merge_sections(run.sections, slam.timer)
        run.episodes.append(dict(
            poses=torch.stack(poses).numpy().astype("float64"), lost=lost,
            scene=config["scene"], rate_hz=config["sensor"]["rate_hz"]))
        del slam
    if tracer is not None:
        tracer.stop()
        run.trace = tracer.digest()
        run.records = tracer.records
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return run


def judge(run: Run, limits: dict) -> None:
    """The reference's numbers for every pose the window returned, each
    beside its limit (``run.check``), and ``run.correct``."""
    from slambench import reference

    got = reference.judge(run.episodes)
    run.check = {name: (got[name], limit) for name, limit in limits.items()}
    run.correct = all(math.isfinite(v) and v <= lim
                      for v, lim in run.check.values())


# ----------------------------------------------------------------------
def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def result_line(bench: dict, workload: str, run: Run, trace: bool,
                kind: str, memory_peak: int) -> dict:
    """The last line: ``correct``, ``attempted``, ``failed``, the
    metrics this run reports, the device, with ``--trace 1`` the
    breakdown, and last the numbers compared beside their limits."""
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": memory_peak}
    out = {"correct": run.correct, "attempted": run.frames,
           "failed": run.lost, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        tr = run.trace
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        ops = sorted(tr.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(tr.idle.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n, s] for n, (s, _) in ops],
                            "idle_gaps": [[n, s] for n, s in gaps]}
    out["card"] = run.card
    # a number that is not finite (no pose, or no pair far enough apart)
    # is printed as null, so that the line stays JSON
    out["check"] = {name: {"value": v if math.isfinite(v) else None,
                           "limit": lim}
                    for name, (v, lim) in run.check.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)

    import torch

    bench = load_benchmark()
    cell, config, traffic, limits = cell_files(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"slambench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = run_cell(config, traffic, args.seed, args.seconds,
                   bool(args.trace), device="cuda")
    memory_peak = torch.cuda.max_memory_allocated()
    judge(run, limits)
    run.card = card_line()
    line = result_line(bench, args.workload, run, bool(args.trace),
                       torch.cuda.get_device_name(0), memory_peak)
    found = banned_modules()
    if found:
        print(f"slambench: modules loaded that the run may not load: "
              f"{found}", file=sys.stderr)
        return 3
    for note in run.notes:
        print(note, file=sys.stderr)
    for name, (v, lim) in run.check.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
