"""The limits of ``kitti00_stereo_orb.live`` and ``kitti00_stereo.batch``
against the faults they must catch.

Both cells render ``kitti00_stereo.live``'s scene and motion (a line
with no rotation at 0.82 m a frame), so the faults are that cell's
(``test_slambench_kitti_check.py``, which this file leaves as it is):

- the scene's exact trajectory, and a window of poses that the program
  returned on the card in the cell (``data/<cell>_window.npz``: the
  episodes of the calibration's seed with the largest one-frame readings,
  float32 as returned), are correct;
- the same scaled by 1.1 are not, by the one-second translation limits;
- every tenth answer turned 3 degrees about the vertical is not, by the
  one-frame rotation mean;
- every other answer turned 0.5 degrees is not, by the one-frame rotation
  limits alone;
- a heading that drifts 0.1 degrees a frame is not, by the one-second
  rotation limits alone;
- every tenth answer moved 0.5 m is not, by the one-frame translation
  mean;
- the exact trajectory rounded to bfloat16, the nearest precision below
  float32, is not.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from slambench import reference
from slambench import run as bench_run
from slambench.tests.test_slambench_kitti_check import (
    alternating, drifting, moved, scaled, turned,
)

CELLS = ["kitti00_stereo_orb.live", "kitti00_stereo.batch"]
BENCH = bench_run.load_benchmark()
DATA = Path(__file__).parent / "data"


def files(cell):
    _, config, _, limits = bench_run.cell_files(BENCH, cell)
    return config, limits


def exact(cell):
    config, _ = files(cell)
    n = config["episode_frames"]
    return [reference.to_poses(reference.relative_truth(config["scene"],
                                                        n))] * 3


def recorded(cell):
    with np.load(DATA / f"{cell.replace('.', '_')}_window.npz") as z:
        return [z[k].astype(np.float64) for k in sorted(z.files)]


def judged(cell, episodes):
    config, limits = files(cell)
    run = bench_run.Run(config, {}, "cpu", None, episodes=[
        dict(poses=p, scene=config["scene"],
             rate_hz=config["sensor"]["rate_hz"]) for p in episodes])
    bench_run.judge(run, limits)
    return run


def over(run):
    return {name for name, (value, limit) in run.check.items()
            if value > limit}


@pytest.mark.parametrize("source", [exact, recorded])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_answers_are_correct(cell, source):
    run = judged(cell, source(cell))
    assert run.correct, run.check


@pytest.mark.parametrize("fault, caught", [
    (scaled, {"rpe1s_p50_mm", "rpe1s_mean_mm"}),
    (turned, {"rot_mean_deg"}),
    (moved, {"rpe_mean_mm"})],
    ids=["scale_1.1", "every_tenth_turned", "every_tenth_moved"])
@pytest.mark.parametrize("source", [exact, recorded])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(cell, source, fault, caught):
    """Each fault fails at least the limits named."""
    run = judged(cell, [fault(p) for p in source(cell)])
    assert not run.correct
    assert caught <= over(run), run.check


@pytest.mark.parametrize("fault, caught", [
    (alternating, {"rot_p50_deg", "rot_mean_deg"}),
    (drifting, {"rot1s_p50_deg", "rot1s_mean_deg"})],
    ids=["every_other_turned", "heading_drift"])
@pytest.mark.parametrize("source", [exact, recorded])
@pytest.mark.parametrize("cell", CELLS)
def test_rotation_faults_are_caught_by_their_limits(cell, source, fault,
                                                    caught):
    """Each of these faults fails the rotation limits named, and no
    other: those limits alone stand between it and ``correct``."""
    run = judged(cell, [fault(p) for p in source(cell)])
    assert not run.correct
    assert over(run) == caught, run.check


@pytest.mark.parametrize("cell", CELLS)
def test_the_exact_trajectory_in_bfloat16_is_not_correct(cell):
    poses = [torch.tensor(p).to(torch.bfloat16).double().numpy()
             for p in exact(cell)]
    run = judged(cell, poses)
    assert not run.correct
    assert over(run) & {"rpe_p50_mm", "rpe_mean_mm"}, run.check
