"""Benchmark: frames/s of the fused tracking step on one card.

Counterpart of the repository's ``bench.py`` (the JAX package's), on the
CUDA card only.  Prints one JSON line under the reference's keys where
they mean the same thing:

* ``tracking_step_fps`` (``value``) and ``on_chip_us_per_frame``:
  ``track_forward`` (B1 FAST+NMS, B2 BRIEF, B3 matcher, P3P RANSAC, GN)
  on ``example_inputs()`` (480 x 640, a 2048-point map slab, 512
  keypoints, 256 hypotheses) by the sequence-delta method: N varied
  frames one after another, timed between CUDA events after a warm
  run, at N = 8 and N = 40; the difference over 32 frames is the
  per-frame time with the start-up of a sequence taken out;
* ``fps_seq_e2e``: 40 frames over the host's wall time of that
  sequence, ending in a synchronize; ``dispatch_roundtrip_ms``: one
  no-op kernel launched and its result read back;
* ``ba_iters_per_s``: LM iterations a second of the local-BA-sized
  problem (8 cameras, 1024 points, 8 observation slots) through B5 and
  B6, by the delta of 100 and 500 iterations;
* ``slam_fps_full_system`` and its split: ``KeyframeSLAM.track_batch``
  (8 frames a dispatch, each dispatch's body one CUDA graph) over 64 and
  192 frames of the reference's VGA ring scene, the delta over 128
  frames; the split is the share of each timer section in the last
  192-frame run;
* ``vs_baseline`` = frames/s over 30 (the reference's camera rate).

The figures are printed unrounded.

Nothing is caught: a kernel that fails to build or launch, or a failed
full-system run, raises.  ``main(frames=...)`` takes the scene's frames
already rendered (192 of them).

    python -m gslam_tpu_torch.bench
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

BASELINE_FPS = 30.0
#: the reference's full-system scene (bench.py:136-151)
SCENE = dict(n_frames=192, n_points=1200, width=640, height=480,
             motion="ring_out", depth=True, texture=True, radius=14.0,
             world_extent=8.0, laps=1, noise=0.01)
FULL_CFG = dict(max_kps=512, fast_threshold=0.08, local_map_size=2048,
                ba_points=1024, kf_max_gap=8, cap_frames=64,
                dispatch_batch=8)
SPLIT = ("slam/track_batch", "slam/extract", "slam/track_fused",
         "slam/keyframe", "slam/local_ba", "slam/hygiene")


def tracking_step(dev: torch.device) -> dict:
    """track_forward by the sequence-delta method (module docstring)."""
    from gslam_tpu_torch.models.graft import example_inputs, track_forward

    img, cam, xyz, desc, valid, _ = example_inputs(device=dev)

    def seq(N: int):
        imgs = [img + i * 1e-6 for i in range(N)]
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        start.record()
        for im in imgs:
            track_forward(im, cam, xyz, desc, valid, generator=gen,
                          max_kps=512, ransac_b=256, device=dev)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, time.perf_counter() - t0

    def best(N: int):
        seq(N)                                  # warm
        runs = [seq(N) for _ in range(3)]
        return min(r[0] for r in runs), min(r[1] for r in runs)

    N1, N2 = 8, 40
    t1, _ = best(N1)
    t2, wall2 = best(N2)
    on_chip = max(t2 - t1, 1e-9) / (N2 - N1)
    return dict(fps=1.0 / on_chip, on_chip_s=on_chip, fps_e2e=N2 / wall2)


def dispatch_roundtrip_ms(dev: torch.device) -> float:
    """One no-op kernel (``x + 1``) launched and its value read back."""
    x = torch.zeros((), device=dev)
    float(x + 1.0)
    t0 = time.perf_counter()
    float(x + 1.0)
    return (time.perf_counter() - t0) * 1e3


def ba_problem(dev: torch.device):
    """The local-BA problem of the reference's ``ba_iters_per_s`` (C = 8
    cameras, P = 1024 points, O = 8 slots), drawn in the same order."""
    from gslam_tpu_torch.opt.ba import BundleProblem

    rng = np.random.default_rng(0)
    C, P, O = 8, 1024, 8
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                  rng.uniform(3, 9, P)], -1).astype(np.float32)
    poses = np.tile(np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32), (C, 1))
    poses[:, 0] = 0.1 * np.arange(C)
    obs_cam = rng.integers(0, C, (P, O)).astype(np.int32)
    pc = X[:, None] + poses[obs_cam][..., :3]
    uv = (pc[..., :2] / pc[..., 2:3]).astype(np.float32)
    uv += rng.normal(0, 5e-4, uv.shape).astype(np.float32)
    cam_fixed = np.zeros(C, bool)
    cam_fixed[0] = True
    xyz = X + rng.normal(0, 0.01, X.shape).astype(np.float32)
    fields = (poses, cam_fixed, xyz, np.zeros(P, bool), obs_cam, uv,
              np.ones((P, O), bool), np.ones((P, O), np.float32))
    return BundleProblem(*(torch.as_tensor(x, device=dev) for x in fields))


def ba_iters_per_s(dev: torch.device) -> float:
    """LM iterations a second through B5 / B6 (module docstring)."""
    from gslam_tpu_torch.opt.ba import bundle_adjust

    problem = ba_problem(dev)

    def t_of(iters: int) -> float:
        bundle_adjust(problem, iters=iters, use_kernels=True)
        torch.cuda.synchronize(dev)
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            bundle_adjust(problem, iters=iters, use_kernels=True)
            torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    t1, t2 = t_of(100), t_of(500)
    return 400.0 / max(t2 - t1, 1e-9)


def render_scene() -> list:
    from gslam_tpu_torch.datasets.synthetic import SyntheticDataset

    ds = SyntheticDataset(**SCENE)
    ds.open("synth://")
    ds.render_ahead(min(8, os.cpu_count() or 1))
    return list(ds)


def slam_full_system(dev: torch.device, frames: list) -> dict:
    """``track_batch`` over 64 and 192 frames (module docstring): a
    fresh system each run, the best of two at each length, after a warm
    48-frame run that only warms the process (each system captures its
    own graphs; the 64 -> 192 delta cancels those captures)."""
    from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig

    camera = frames[0].camera

    def run(n: int):
        slam = KeyframeSLAM(camera, SLAMConfig(**FULL_CFG), device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        slam.track_batch(frames[:n])
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, slam

    run(48)
    t1 = min(run(64)[0] for _ in range(2))
    runs = [run(192) for _ in range(2)]
    t2 = min(t for t, _ in runs)
    per_frame = max(t2 - t1, 1e-9) / 128.0
    st = runs[-1][1].timer.stats()
    split_s = {k: st.get(k, {"total": 0.0})["total"] for k in SPLIT}
    tot = sum(split_s.values()) or 1.0
    return {
        "slam_fps_full_system": 1.0 / per_frame,
        "slam_full_ms_per_frame": per_frame * 1e3,
        "slam_full_split_frac": {k.split("/")[1]: v / tot
                                 for k, v in split_s.items()},
        "slam_full_config": {"frames": "64->192 delta", "batch": 8,
                             "loop_closure": "off"},
    }


def main(frames: Optional[List] = None) -> dict:
    """Measure, print the JSON line, and return it as a dict.
    ``frames``: the scene's 192 frames, rendered by the caller."""
    from gslam_tpu_torch.utils.platform import require_device

    dev = require_device("cuda")
    step = tracking_step(dev)
    rt = dispatch_roundtrip_ms(dev)
    ba_its = ba_iters_per_s(dev)
    full = slam_full_system(dev, render_scene() if frames is None
                            else frames)
    fps = step["fps"]
    line = {
        "metric": "tracking_step_fps",
        "value": fps,
        "unit": "frames/s/card (on-card, sequence-delta)",
        "vs_baseline": fps / BASELINE_FPS,
        "variant": "cuda",
        "on_chip_us_per_frame": step["on_chip_s"] * 1e6,
        "fps_seq_e2e": step["fps_e2e"],
        "dispatch_roundtrip_ms": rt,
        "ba_iters_per_s": ba_its,
        **full,
        "device": {"kind": torch.cuda.get_device_name(dev),
                   "count": torch.cuda.device_count()},
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
