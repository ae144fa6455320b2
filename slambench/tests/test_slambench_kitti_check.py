"""The limits of ``kitti00_stereo.live`` against the faults they must
catch.

The line motion has no rotation, so the ``inverted`` control (a
world-to-camera answer) reads 0 degrees and tests only the translation
limits, and a 10% scale error moves the one-second translation by 820 mm.
So besides the two controls that every cell fails
(``test_slambench_check.py``):

- the scene's exact trajectory, and a window of poses that the program
  returned on the card (``data/kitti00_stereo_live_window.npz``: 16
  episodes of the calibration's seed with the largest one-frame readings,
  float32 as returned), are correct;
- the same, scaled by 1.1 (``reference.scale_control``'s fault), are not:
  the one-second limits lie below its reading;
- the same with every tenth answer turned 3 degrees about the vertical,
  its position kept (``test_slambench_check.py``'s ``turned`` fault where
  the answers are produced), are not: the one-frame mean lies above the
  largest sound reading and below this one;
- the same with every other answer turned 0.5 degrees are not, by the
  one-frame rotation limits alone: the median lies between the sound
  readings (0.126-0.138 degrees) and this fault's (0.50-0.52);
- the same with a heading that drifts 0.1 degrees a frame (each answer's
  motion from the one before turned so, its position following the
  heading) are not, by the one-second rotation limits alone: they lie
  between the sound readings (0.33-0.42 degrees) and this fault's
  (1.00-1.08);
- the same with every tenth answer moved 0.5 m (its ``altered`` fault)
  are not: the one-frame mean lies below that reading.
"""

from pathlib import Path

import numpy as np
import pytest

from slambench import reference
from slambench import run as bench_run

CELL = "kitti00_stereo.live"
BENCH = bench_run.load_benchmark()
_, CONFIG, _, LIMITS = bench_run.cell_files(BENCH, CELL)
SCENE = CONFIG["scene"]
WINDOW = Path(__file__).parent / "data" / "kitti00_stereo_live_window.npz"


def exact():
    n = CONFIG["episode_frames"]
    return [reference.to_poses(reference.relative_truth(SCENE, n))] * 3


def recorded():
    with np.load(WINDOW) as z:
        return [z[k].astype(np.float64) for k in sorted(z.files)]


def scaled(poses, factor=1.1):
    out = poses.copy()
    out[:, :3] *= factor
    return out


def turned(poses, degrees=3.0):
    """Every tenth answer (frame ids 5, 15, ...) turned about the
    vertical where it is produced: its quaternion times a rotation of
    ``degrees`` about y."""
    out = poses.copy()
    a = np.radians(degrees) / 2
    c, s = np.cos(a), np.sin(a)
    for i in range(5, len(out), 10):
        w, x, y, z = out[i, 3:7]
        out[i, 3:7] = [w * c - y * s, x * c - z * s, y * c + w * s,
                       z * c + x * s]
    return out


def qmul(a, b):
    """Hamilton product of wxyz quaternions."""
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def about_y(degrees):
    a = np.radians(degrees) / 2
    return np.array([np.cos(a), 0.0, np.sin(a), 0.0])


def alternating(poses, degrees=0.5):
    """Every other answer (odd frame ids) turned about the vertical, its
    position kept."""
    out = poses.copy()
    for i in range(1, len(out), 2):
        out[i, 3:7] = qmul(out[i, 3:7], about_y(degrees))
    return out


def drifting(poses, degrees=0.1):
    """A heading that drifts ``degrees`` a frame: each answer's motion from
    the one before, as the poses have it, turned about the vertical by
    that much more, and the positions chained along the turned heading."""
    q = poses[:, 3:7] / np.linalg.norm(poses[:, 3:7], axis=1, keepdims=True)
    R = reference.quat_to_matrix(q)
    out = poses.copy()
    out[:, 3:7] = q
    for k in range(1, len(out)):
        step = R[k - 1].T @ (poses[k, :3] - poses[k - 1, :3])
        out[k, :3] = out[k - 1, :3] + \
            reference.quat_to_matrix(out[k - 1, 3:7]) @ step
        turn = qmul(q[k - 1] * [1, -1, -1, -1], q[k])
        out[k, 3:7] = qmul(qmul(out[k - 1, 3:7], turn), about_y(degrees))
    return out


def moved(poses, metres=0.5):
    """Every tenth answer (frame ids 5, 15, ...) moved along x."""
    out = poses.copy()
    out[5::10, 0] += metres
    return out


def judged(episodes):
    run = bench_run.Run(CONFIG, {}, "cpu", None, episodes=[
        dict(poses=p, scene=SCENE, rate_hz=CONFIG["sensor"]["rate_hz"])
        for p in episodes])
    bench_run.judge(run, LIMITS)
    return run


@pytest.mark.parametrize("source", [exact, recorded])
def test_sound_answers_are_correct(source):
    run = judged(source())
    assert run.correct, run.check


@pytest.mark.parametrize("source", [exact, recorded])
def test_a_ten_percent_scale_error_is_not_correct(source):
    run = judged([scaled(p) for p in source()])
    assert not run.correct
    for name in ("rpe1s_p50_mm", "rpe1s_mean_mm"):
        value, limit = run.check[name]
        assert value > limit, (name, value, limit)


@pytest.mark.parametrize("source", [exact, recorded])
def test_every_tenth_answer_turned_is_not_correct(source):
    run = judged([turned(p) for p in source()])
    assert not run.correct
    value, limit = run.check["rot_mean_deg"]
    assert value > limit, (value, limit)


@pytest.mark.parametrize("fault, caught", [
    (alternating, {"rot_p50_deg", "rot_mean_deg"}),
    (drifting, {"rot1s_p50_deg", "rot1s_mean_deg"})],
    ids=["every_other_turned", "heading_drift"])
@pytest.mark.parametrize("source", [exact, recorded])
def test_rotation_faults_are_caught_by_their_limits(source, fault, caught):
    """Each of these faults fails the rotation limits named, and no
    other: those limits alone stand between it and ``correct``."""
    run = judged([fault(p) for p in source()])
    assert not run.correct
    over = {name for name, (value, limit) in run.check.items()
            if value > limit}
    assert over == caught, run.check


@pytest.mark.parametrize("source", [exact, recorded])
def test_every_tenth_answer_moved_is_not_correct(source):
    run = judged([moved(p) for p in source()])
    assert not run.correct
    value, limit = run.check["rpe_mean_mm"]
    assert value > limit, (value, limit)


def test_the_controls_read_as_expected():
    """What the limits are set between: the inverted control's 1640 mm a
    frame (twice the 0.82 m step) and 0 degrees, the scale error's 820 mm
    a second."""
    n = CONFIG["episode_frames"]
    eps = [dict(poses=reference.inverted_control(SCENE, n), scene=SCENE,
                rate_hz=10)]
    got = reference.judge(eps)
    assert got["rpe_p50_mm"] == pytest.approx(1640.0)
    assert got["rot_mean_deg"] == pytest.approx(0.0, abs=1e-6)
    eps[0]["poses"] = reference.scale_control(SCENE, n, 1.1)
    assert reference.judge(eps)["rpe1s_p50_mm"] == pytest.approx(820.0)
