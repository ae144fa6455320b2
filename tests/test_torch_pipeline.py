"""The port's messenger-wired pipeline (gslam_tpu_torch.models.pipeline)
and dataset player against the direct ``track`` loop and the JAX
package's pipeline.

* ``SLAMPipeline`` fed by ``DatasetPlayer(rate=0)``, its frame queue as
  long as the sequence: the poses published
  on ``slam/curframe`` are bit for bit those of a direct ``track`` loop
  with the same configuration and seed (the same draws), the ids in
  order, at least one ``slam/map`` message, and ``slam/eos`` with every
  frame; the JAX package's pipeline over the same sequence publishes the
  same ids (tests/test_slam_e2e.py:283-318).
* A published map is never written afterwards: every arena on
  ``slam/map`` equals a copy taken when it was published, after the
  rest of the run (local BA write-back, hygiene, and a loop closure on
  the revisited ring with a vocabulary).
* A ``track`` that raises ends the run there: ``wait`` raises it, and
  no later frame is tracked.
* The player's play / pause / step and its real-time rate.
"""

import dataclasses
import importlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from gslam_tpu_torch.app.registry import open_dataset
from gslam_tpu_torch.datasets.base import (EOS_TOPIC, FRAME_TOPIC, Dataset,
                                           DatasetPlayer)
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.models.pipeline import (CURFRAME_TOPIC, MAP_TOPIC,
                                             SLAM_EOS_TOPIC, SLAMPipeline)
from tests.test_torch_loop_closure import CFG as RING_CFG
from tests.test_torch_loop_closure import ring_frames, ring_vocabulary

torch.set_num_threads(2)
Messenger = importlib.import_module("gslam_tpu_torch.app.messenger").Messenger

SEQ = {"n_frames": 10, "n_points": 300, "width": 192, "height": 144,
       "motion": "line", "depth": True}
CFG = dict(max_kps=192, fast_threshold=0.1, ba_window=4, ba_points=256,
           ba_iters=3, cap_frames=32, cap_points=2048, cap_obs=8192,
           local_map_size=384, kf_max_gap=3)


class FrameList(Dataset):
    """A dataset over frames already in memory."""

    def __init__(self, frames):
        super().__init__()
        self.frames = frames
        self.open("")

    def _open(self, path):
        return True

    def _grab(self, idx):
        return self.frames[idx] if idx < len(self.frames) else None

    def _length(self):
        return len(self.frames)


def synth_path(tmp_path, **over):
    path = str(tmp_path / "p.synth")
    with open(path, "w") as f:
        f.write(json.dumps({**SEQ, **over}))
    return path


def run_pipeline(slam, ds, on_map=None):
    """Player -> bus -> SLAM -> bus over ``ds``, the frame queue as long
    as the dataset (the default 8 drops the oldest frames when tracking
    falls behind a player at full speed); returns (curframe messages,
    map messages, the eos message)."""
    bus = Messenger()
    poses, maps, eos = [], [], []
    bus.subscribe(CURFRAME_TOPIC, 0, poses.append)
    bus.subscribe(MAP_TOPIC, 0, on_map or maps.append)
    bus.subscribe(SLAM_EOS_TOPIC, 0, eos.append)
    pipe = SLAMPipeline(slam, bus=bus, queue_size=len(ds))
    player = DatasetPlayer(ds, bus=bus, rate=0.0).start()
    try:
        assert pipe.wait(300.0)
    finally:
        player.stop()
        pipe.shutdown()
    return poses, maps, eos


def test_pipeline_poses_bit_for_bit_the_direct_loop(tmp_path):
    path = synth_path(tmp_path)
    ds = open_dataset(path)
    slam = KeyframeSLAM(ds.camera, SLAMConfig(**CFG), device="cpu")
    poses, maps, eos = run_pipeline(slam, ds)

    direct = KeyframeSLAM(ds.camera, SLAMConfig(**CFG), device="cpu")
    want = [direct.track(fr).numpy() for fr in open_dataset(path)]
    assert [p["id"] for p in poses] == list(range(SEQ["n_frames"]))
    for p, w in zip(poses, want):
        assert isinstance(p["pose"], np.ndarray) and p["pose"].shape == (7,)
        np.testing.assert_array_equal(p["pose"], w)
        assert "n_inliers" in p
    assert len(maps) >= 1
    assert len(eos) == 1 and eos[0]["frames"] == SEQ["n_frames"]
    np.testing.assert_array_equal(eos[0]["positions"], direct.positions())


@pytest.fixture(scope="module")
def reference_ids(tmp_path_factory):
    """tests/test_slam_e2e.py:283-318: the JAX package's pipeline over 6
    frames at 160x120."""
    from gslam_tpu.app.messenger import Messenger as JMessenger
    from gslam_tpu.app.registry import open_dataset as j_open
    from gslam_tpu.datasets.base import DatasetPlayer as JPlayer
    from gslam_tpu.models.keyframe_slam import KeyframeSLAM as JSLAM
    from gslam_tpu.models.keyframe_slam import SLAMConfig as JConfig
    from gslam_tpu.models.pipeline import CURFRAME_TOPIC as J_CUR
    from gslam_tpu.models.pipeline import MAP_TOPIC as J_MAP
    from gslam_tpu.models.pipeline import SLAMPipeline as JPipeline

    path = synth_path(tmp_path_factory.mktemp("ref"), n_frames=6,
                      n_points=200, width=160, height=120)
    ds = j_open(path)
    bus = JMessenger()
    slam = JSLAM(ds.camera, JConfig(
        max_kps=128, fast_threshold=0.1, cap_frames=16, cap_points=1024,
        cap_obs=4096, local_map_size=256, ba_points=128, ba_window=3))
    poses, maps = [], []
    bus.subscribe(J_CUR, 0, poses.append)
    bus.subscribe(J_MAP, 0, maps.append)
    pipe = JPipeline(slam, bus=bus)
    player = JPlayer(ds, bus=bus, rate=0.0).start()
    assert pipe.wait(120.0)
    player.stop()
    pipe.shutdown()
    return path, [p["id"] for p in poses], len(maps) >= 1


def test_pipeline_same_ids_as_reference(reference_ids):
    path, ids_j, maps_j = reference_ids
    ds = open_dataset(path)
    slam = KeyframeSLAM(ds.camera, SLAMConfig(
        max_kps=128, fast_threshold=0.1, cap_frames=16, cap_points=1024,
        cap_obs=4096, local_map_size=256, ba_points=128, ba_window=3),
        device="cpu")
    poses, maps, _ = run_pipeline(slam, ds)
    assert [p["id"] for p in poses] == ids_j == list(range(6))
    assert all(p["pose"].shape == (7,) for p in poses)
    assert (len(maps) >= 1) == maps_j


def snapshot(arena):
    return {name: t.clone() for name, t in arena.tensors()}


def test_published_maps_are_never_written(tmp_path):
    """Each slam/map arena against its copy at publish, after the run:
    local BA, hygiene and a loop closure ran after the first publish."""
    frames = ring_frames(48, revisit=10)
    voc, _ = ring_vocabulary()
    slam = KeyframeSLAM(frames[0].camera, SLAMConfig(**RING_CFG),
                        vocabulary=voc, device="cpu")
    published = []
    poses, _, _ = run_pipeline(
        slam, FrameList(frames),
        on_map=lambda a: published.append((a, snapshot(a))))
    assert len(poses) == len(frames)
    assert len(published) >= 3
    assert slam.timer.stats()["slam/local_ba"]["count"] >= 2
    assert slam.timer.stats()["slam/hygiene"]["count"] >= 1
    assert len(slam.loop_closer.closed) >= 1
    for arena, copy in published:
        for name, t in arena.tensors():
            assert torch.equal(t, copy[name]), name
    # and the live map did move on from the first published one
    first = published[0][0]
    assert not torch.equal(first.frame_pose, slam.arena.frame_pose)


class FailingSLAM:
    """A system whose ``track`` raises at frame ``fail_at``, as a kernel
    that fails to build or launch would."""

    def __init__(self, fail_at):
        self.fail_at = fail_at
        self.tracked, self.stats, self.trajectory = [], [], []

    def track(self, frame):
        if frame.id == self.fail_at:
            raise RuntimeError(f"launch failed at frame {frame.id}")
        self.tracked.append(frame.id)
        return torch.zeros(7)


def test_a_failed_track_makes_wait_raise():
    frames = [dataclasses.replace(f) for f in ring_frames(6)]
    slam = FailingSLAM(fail_at=2)
    bus = Messenger()
    poses, eos = [], []
    bus.subscribe(CURFRAME_TOPIC, 0, poses.append)
    bus.subscribe(SLAM_EOS_TOPIC, 0, eos.append)
    pipe = SLAMPipeline(slam, bus=bus, queue_size=len(frames))
    player = DatasetPlayer(FrameList(frames), bus=bus, rate=0.0).start()
    try:
        with pytest.raises(RuntimeError, match="launch failed at frame 2"):
            pipe.wait(30.0)
        player.join(5.0)
    finally:
        player.stop()
        pipe.shutdown()
    assert slam.tracked == [0, 1]
    assert [p["id"] for p in poses] == [0, 1]
    assert eos == [] and not pipe.done.is_set()


def test_player_pause_step_and_play():
    frames = [dataclasses.replace(f) for f in ring_frames(4)]
    bus = Messenger()
    got, eos = [], []
    bus.subscribe(FRAME_TOPIC, 0, lambda f: got.append(f.id))
    bus.subscribe(EOS_TOPIC, 0, eos.append)
    player = DatasetPlayer(FrameList(frames), bus=bus).start(playing=False)
    try:
        time.sleep(0.05)
        assert got == []
        player.step()
        for _ in range(200):
            if got:
                break
            time.sleep(0.005)
        time.sleep(0.05)
        assert got == [0]
        player.play()
        player.join(5.0)
        assert got == [0, 1, 2, 3] and eos == [{"frames": 4}]
    finally:
        player.stop()


def test_player_rate_follows_the_timestamps():
    frames = [dataclasses.replace(f, timestamp=0.05 * i)
              for i, f in enumerate(ring_frames(4))]
    bus = Messenger()
    stamps = []
    done = threading.Event()
    bus.subscribe(FRAME_TOPIC, 0, lambda f: stamps.append(time.perf_counter()))
    bus.subscribe(EOS_TOPIC, 0, lambda m: done.set())
    DatasetPlayer(FrameList(frames), bus=bus, rate=1.0).start()
    assert done.wait(5.0)
    assert stamps[-1] - stamps[0] >= 0.15 * 0.9
