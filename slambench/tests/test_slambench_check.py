"""What decides ``correct`` comes out false where it has to.

Each control (the reference put in the program's place with one of the
configuration's guarantees broken) fails every cell's limits at the
cells' own episode length.  Then runs of the harness on the CPU, its
look for a card skipped, with the timed path broken underneath: a system
whose state never changes, half of each batch left out, answers altered
where they are produced (moved, or only turned).  Each must come out not
correct, and the same run unbroken correct.
"""

import numpy as np
import pytest

from slambench import reference
from slambench import run as bench_run

BENCH = bench_run.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("control", ["inverted_control",
                                     "skipping_control"])
@pytest.mark.parametrize("workload", CELLS)
def test_the_controls_fail(workload, control):
    _, config, _, limits = bench_run.cell_files(BENCH, workload)
    n = config["episode_frames"]
    make = getattr(reference, control)
    eps = [dict(poses=make(config["scene"], n), scene=config["scene"],
                rate_hz=config["sensor"]["rate_hz"]) for _ in range(3)]
    run = bench_run.Run(config, {}, "cpu", None, episodes=eps)
    bench_run.judge(run, limits)
    assert run.correct is False


def stuck(self, frame):
    """A step that returns its state unchanged."""
    return self.pose_wc


def half_batch(original):
    def track_batch(self, frames):
        """Half of the batch left out: every other frame tracked, the
        one after it answered with its pose."""
        poses = original(self, frames[::2])
        return [poses[i // 2] for i in range(len(frames))]
    return track_batch


def altered(original):
    def track(self, frame):
        """Every tenth answer moved 0.5 m where it is produced."""
        pose = original(self, frame)
        if frame.id % 10 == 5:
            pose = pose.clone()
            pose[0] += 0.5
        return pose
    return track


def turned(original):
    def track(self, frame):
        """Every tenth answer turned 3 degrees about the vertical where
        it is produced, its position kept."""
        pose = original(self, frame)
        if frame.id % 10 == 5:
            a = np.radians(3.0) / 2
            q = pose[3:7].clone()          # w, x, y, z
            w, x, y, z = q
            c, s = float(np.cos(a)), float(np.sin(a))
            pose = pose.clone()            # q * (cos a, 0, sin a, 0)
            pose[3] = w * c - y * s
            pose[4] = x * c - z * s
            pose[5] = y * c + w * s
            pose[6] = z * c + x * s
        return pose
    return track


def small_run(workload, seconds=8.0):
    _, config, traffic, limits = bench_run.cell_files(BENCH, workload)
    config = dict(config, episode_frames=48, draws=1)
    traffic = dict(traffic, warm_frames=min(traffic["warm_frames"], 24))
    run = bench_run.run_cell(config, traffic, 2147483901, seconds, False,
                             device="cpu")
    bench_run.judge(run, limits)
    return run


@pytest.mark.parametrize("workload,fault", [
    ("tum_fr3_rgbd.live", None), ("tum_fr3_rgbd.live", "stuck"),
    ("tum_fr3_rgbd.live", "altered"), ("tum_fr3_rgbd.live", "turned"),
    ("tum_fr3_rgbd.batch", None),
    ("tum_fr3_rgbd.batch", "half_batch")])
def test_faults(monkeypatch, workload, fault):
    from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM
    if fault == "stuck":
        monkeypatch.setattr(KeyframeSLAM, "track", stuck)
    elif fault == "altered":
        monkeypatch.setattr(KeyframeSLAM, "track",
                            altered(KeyframeSLAM.track))
    elif fault == "turned":
        monkeypatch.setattr(KeyframeSLAM, "track",
                            turned(KeyframeSLAM.track))
    elif fault == "half_batch":
        monkeypatch.setattr(KeyframeSLAM, "track_batch",
                            half_batch(KeyframeSLAM.track_batch))
    run = small_run(workload)
    assert run.frames > 40
    numbers = {k: v for k, (v, _) in run.check.items()}
    assert run.correct is (fault is None), numbers
    assert all(np.isfinite(v) for v in numbers.values()) or fault
