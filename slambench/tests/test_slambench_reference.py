"""The reference's arithmetic on hand-made trajectories, and the
controls."""

import numpy as np
import pytest

from slambench import reference

RING = dict(motion="ring_out", lap_frames=1060, radius=1.4003)
LINE = dict(motion="line", lap_frames=96, step=0.08)


def episode(poses, scene=RING, rate_hz=30):
    return dict(poses=poses, scene=scene, rate_hz=rate_hz)


def test_exact_answers_read_zero_in_any_gauge():
    got = reference.judge([episode(reference.to_poses(
        reference.relative_truth(RING, 64)))])
    assert max(got.values()) < 1e-5


def test_ate_of_a_known_offset():
    # offsets no rigid motion can take away: +-1 cm off the plane of a
    # square, alternating round it
    gt = np.array([[1.0, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0]])
    est = gt + np.array([[0, 0, 0.01], [0, 0, -0.01]] * 2)
    assert reference.ate_rmse(est, gt) == pytest.approx(0.01, rel=1e-9)
    rot = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    assert reference.ate_rmse(gt @ rot.T + 3.0, gt) < 1e-9


def test_rpe_of_a_stuck_tracker_is_the_motion():
    T = reference.trajectory(LINE, 20)
    stuck = np.tile(np.eye(4), (20, 1, 1))
    t, r = reference.rpe_gaps(stuck, T)
    assert np.allclose(t, 0.08) and np.allclose(r, 0.0)
    t, r = reference.rpe_gaps(stuck, T, 5)
    assert np.allclose(t, 0.4)
    T = reference.trajectory(RING, 40)
    t, r = reference.rpe_gaps(np.tile(np.eye(4), (40, 1, 1)), T)
    assert np.allclose(r, 360.0 / 1060)


def test_a_turn_alone_reads_in_the_rotation_gap():
    rel = reference.relative_truth(RING, 61)
    a = np.radians(3.0)
    turn = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]])
    rel[10, :3, :3] = rel[10, :3, :3] @ turn
    t, r = reference.rpe_gaps(rel, reference.trajectory(RING, 61))
    assert r[9] == pytest.approx(3.0) and r[10] == pytest.approx(3.0)
    assert np.delete(r, [9, 10]).max() < 1e-5
    # the translation of the motion out of frame 10 turns with it
    assert t[10] == pytest.approx(2 * 0.0083 * np.sin(a / 2), rel=1e-2)
    got = reference.judge([episode(reference.to_poses(rel))])
    assert got["rot_mean_deg"] == pytest.approx(6.0 / 60, rel=1e-4)
    assert got["rot1s_mean_deg"] == pytest.approx(3.0 / 31, rel=1e-4)


def test_the_controls():
    n = 192
    rel = reference.relative_truth(RING, n)
    skip = reference.poses_to_matrices(reference.skipping_control(RING, n))
    assert np.abs(skip[::2] - rel[::2]).max() < 1e-12
    assert np.abs(skip[1::2] - rel[0:n - 1:2]).max() < 1e-12
    got = reference.judge([episode(reference.skipping_control(RING, n))])
    assert got["stale_pct"] == pytest.approx(100 * 96 / 191)
    assert got["rpe_p50_mm"] == pytest.approx(
        2e3 * 1.4003 * np.sin(np.pi / 1060), rel=1e-6)
    inv = reference.poses_to_matrices(reference.inverted_control(RING, n))
    assert np.abs(inv @ rel - np.eye(4)).max() < 1e-12
    got = reference.judge([episode(reference.inverted_control(RING, n))])
    assert got["rot_p50_deg"] == pytest.approx(2 * 360 / 1060, rel=1e-6)
    assert got["stale_pct"] == 0.0
    got = reference.judge([episode(reference.scale_control(RING, n, 1.1))])
    assert got["rot1s_p50_deg"] < 1e-5
    assert got["rpe1s_p50_mm"] == pytest.approx(24.87, abs=0.01)


def test_judge_of_nan_poses_is_infinite():
    p = np.full((40, 7), np.nan)
    got = reference.judge([episode(p)])
    assert got["rpe_p50_mm"] == float("inf")
    assert got["rot1s_mean_deg"] == float("inf")
