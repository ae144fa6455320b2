"""The limits of ``tum_fr3_dvo.live`` against the faults they must catch.

The cell renders ``tum_fr3_rgbd``'s ring (8.3 mm and 0.340 degrees a
frame about the vertical), and its answers come from dense direct
alignment, so its limits lie far below the TUM cell's:

- the scene's exact trajectory, and a window of poses that the program
  returned on the card in the cell (``data/tum_fr3_dvo_live_window.npz``:
  the episodes of the calibration's seeds with the largest one-frame
  readings, float32 as returned), are correct;
- the same scaled by 1.1 are not, by the one-second translation limits;
- every tenth answer turned 3 degrees about the vertical is not, by the
  one-frame rotation mean;
- every other answer turned 0.5 degrees is not, by the one-frame rotation
  limits;
- a heading that drifts 0.1 degrees a frame is not, by the one-second
  rotation limits;
- every tenth answer moved 0.5 m is not, by the one-frame translation
  mean;
- every other answer repeating the one before (a tracker that skips
  frames) is not, by ``stale_pct``;
- the exact trajectory rounded to bfloat16, the nearest precision below
  float32, is not.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from slambench import run as bench_run
from slambench.tests.test_slambench_kitti_check import (
    alternating, drifting, moved, scaled, turned,
)
from slambench.tests.test_slambench_stereo_cells_check import exact

CELL = "tum_fr3_dvo.live"
BENCH = bench_run.load_benchmark()
_, CONFIG, _, LIMITS = bench_run.cell_files(BENCH, CELL)
WINDOW = Path(__file__).parent / "data" / "tum_fr3_dvo_live_window.npz"


def recorded(cell=CELL):
    with np.load(WINDOW) as z:
        return [z[k].astype(np.float64) for k in sorted(z.files)]


def skipping(poses):
    """Every other answer (odd frame ids) the one before it."""
    out = poses.copy()
    out[1::2] = out[0:len(out) - 1:2]
    return out


def judged(episodes):
    run = bench_run.Run(CONFIG, {}, "cpu", None, episodes=[
        dict(poses=p, scene=CONFIG["scene"],
             rate_hz=CONFIG["sensor"]["rate_hz"]) for p in episodes])
    bench_run.judge(run, LIMITS)
    return run


def over(run):
    return {name for name, (value, limit) in run.check.items()
            if value > limit}


@pytest.mark.parametrize("source", [exact, recorded])
def test_sound_answers_are_correct(source):
    run = judged(source(CELL))
    assert run.correct, run.check


@pytest.mark.parametrize("fault, caught", [
    (scaled, {"rpe1s_p50_mm", "rpe1s_mean_mm"}),
    (turned, {"rot_mean_deg"}),
    (alternating, {"rot_p50_deg", "rot_mean_deg"}),
    (drifting, {"rot1s_p50_deg", "rot1s_mean_deg"}),
    (moved, {"rpe_mean_mm"}),
    (skipping, {"stale_pct"})],
    ids=["scale_1.1", "every_tenth_turned", "every_other_turned",
         "heading_drift", "every_tenth_moved", "skipping"])
@pytest.mark.parametrize("source", [exact, recorded])
def test_faults_are_not_correct(source, fault, caught):
    """Each fault fails at least the limits named."""
    run = judged([fault(p) for p in source(CELL)])
    assert not run.correct
    assert caught <= over(run), run.check


def test_the_exact_trajectory_in_bfloat16_is_not_correct():
    poses = [torch.tensor(p).to(torch.bfloat16).double().numpy()
             for p in exact(CELL)]
    run = judged(poses)
    assert not run.correct
    assert over(run) & {"rpe_p50_mm", "rpe_mean_mm"}, run.check
