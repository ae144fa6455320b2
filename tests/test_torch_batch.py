"""The port's batched dispatch (KeyframeSLAM.track_batch) against its own
sequential track() and against the JAX package's track_batch, on the
192 x 144 sequences and configuration of tests/test_torch_slam.py.

* Against the port's sequential path, with the same RANSAC uniforms fed
  to both frame by frame (``FrameDraws``): the K-frame body runs the
  same operations on the CPU as ``track`` does, so every pose, the
  keyframes, the landmark visible / found counters and the stats rows
  are equal (poses to 1e-6; in practice bit for bit).
* Against the JAX package's ``track_batch`` on the same frames: the
  bookkeeping (a trajectory entry, a keyframe-relative pose, a
  timestamp and a stats row per frame), keyframes within 1, ATE within
  0.01 m of the JAX run's and within tests/test_slam_e2e.py's gate of
  the sequential run (the draws differ, so the runs are not equal).
* A batch whose first frame triggers (nothing accepted) and a short
  tail take the paths the reference takes for them.
* The K-frame body reads nothing back to the host and copies nothing
  from it, which the card's graph capture needs (checked here on the CPU
  by the operators it dispatches).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gslam_tpu.eval import evaluate_trajectory as j_eval
from gslam_tpu.models.keyframe_slam import KeyframeSLAM as JSLAM
from gslam_tpu.models.keyframe_slam import SLAMConfig as JConfig
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.map.arena import arena_stats
from gslam_tpu_torch.models.keyframe_slam import (
    BatchResult, KeyframeSLAM, SLAMConfig,
)
from gslam_tpu_torch.ops.cuda.graphs import tensor_leaves
from tests.test_torch_slam import (
    CFG, FULL_CFG, FULL_SEQUENCE, JData, datasets,
)

torch.set_num_threads(2)

N_FRAMES = 24


class FrameDraws:
    """A ``uniforms`` hook that hands the draws of frame f to whatever
    tracks frame f: ``track`` calls it once for the frame it tracks, a
    batch K times at its start for its K frames (frames counted by the
    system's trajectory).  The two-view bootstrap gets its pair."""

    def __init__(self, n, seed=5):
        rng = np.random.default_rng(seed)
        self.pnp = torch.as_tensor(rng.random((n, 256, 4), dtype=np.float32))
        self.two_view = [
            (torch.as_tensor(rng.random((256, 8), dtype=np.float32)),
             torch.as_tensor(rng.random((256, 4), dtype=np.float32)))
            for _ in range(n)]
        self.slam = None
        self._at = (-1, 0)

    def __call__(self):
        t = len(self.slam.trajectory)
        k = self._at[1] if self._at[0] == t else 0
        self._at = (t, k + 1)
        if not self.slam.initialized:
            return self.two_view[t + k]
        return self.pnp[t + k]


def port_run(frames, camera, cfg, batched):
    draws = FrameDraws(len(frames))
    slam = KeyframeSLAM(camera, SLAMConfig(**cfg), device="cpu",
                        uniforms=draws)
    draws.slam = slam
    if batched:
        poses = slam.track_batch(frames)
    else:
        poses = [slam.track(f) for f in frames]
    return slam, poses


def keyframe_times(slam):
    n = int(slam.arena.n_frames)
    return slam.arena.frame_time[:n].tolist()


def assert_same_run(a, b):
    np.testing.assert_allclose(torch.stack(b.trajectory).numpy(),
                               torch.stack(a.trajectory).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        torch.stack([r for _, r in b._traj_rel]).numpy(),
        torch.stack([r for _, r in a._traj_rel]).numpy(), atol=1e-6)
    assert [k for k, _ in b._traj_rel] == [k for k, _ in a._traj_rel]
    assert keyframe_times(b) == keyframe_times(a)
    assert b.last_kf_id == a.last_kf_id
    assert b.stats == a.stats and b.timestamps == a.timestamps
    for name in ("point_visible", "point_found", "point_valid", "obs_point",
                 "obs_frame"):
        assert torch.equal(getattr(b.arena, name), getattr(a.arena, name)), \
            name


@pytest.mark.parametrize("over", [{}, dict(kf_min_gap=2, kf_max_gap=5)],
                         ids=["stock", "keyframes_every_5"])
def test_batch_equals_sequential(over):
    cfg = dict(CFG, **over)
    _, dt = datasets(n_frames=N_FRAMES)
    frames = list(dt)
    seq, _ = port_run(frames, dt.camera, cfg, batched=False)
    bat, poses = port_run(frames, dt.camera, dict(cfg, dispatch_batch=4),
                          batched=True)
    assert len(poses) == N_FRAMES
    assert_same_run(seq, bat)
    st = bat.timer.stats()
    assert st["slam/track_batch"]["count"] >= 3
    assert bat._n_frames_host >= (2 if not over else 5)


def test_batch_body_state():
    """The body's frozen trigger state is the trigger frame's own
    extraction, matching and PnP, and the accepted prefix's pose and
    motion model are what track() leaves."""
    cfg = dict(CFG, kf_min_gap=2, kf_max_gap=3, dispatch_batch=4)
    _, dt = datasets(n_frames=8)
    frames = list(dt)
    slam, _ = port_run(frames[:1], dt.camera, cfg, batched=False)
    draws = FrameDraws(8)
    draws.slam = slam
    slam._uniforms = draws
    slab_ids, xyz, desc, valid = slam._slab(slam.arena, "slam/track_batch")
    imgs = torch.stack([torch.as_tensor(f.image) for f in frames[1:5]])
    res = slam._run_batch(slam._batch_inputs(
        imgs, slam._batch_uniforms(4), xyz, desc, valid))
    assert isinstance(res, BatchResult) and res.rows.shape == (4, 19)
    assert all(t.device.type == "cpu" for t in tensor_leaves(res))
    first = res.rows[:, 17].numpy()
    # kf_max_gap 3: frames 1, 2 accepted, frame 3 the first trigger
    np.testing.assert_array_equal(first, [0, 0, 1, 0])
    assert res.rows[:, 18].numpy().all()              # all tracked
    ref, _ = port_run(frames[:4], dt.camera, dict(cfg, dispatch_batch=1),
                      batched=False)
    np.testing.assert_allclose(res.pose_wc.numpy(),
                               ref.trajectory[2].numpy(), atol=1e-6)
    np.testing.assert_allclose(res.rows[1, :7].numpy(),
                               res.pose_wc.numpy(), atol=0)
    # the trigger frame's state, as track() computed it for frame 3
    _, m3, inl3 = ref._last_track
    assert torch.equal(res.feats.desc, ref._prev_feats.desc)
    assert torch.equal(res.matches.idx, m3.idx)
    assert torch.equal(res.inliers, inl3)
    assert int(res.rows[2, 14]) == ref.stats[3]["n_inliers"]


def test_trigger_at_batch_head_and_short_tail():
    """A keyframe every frame: each batch stops at its first frame
    (nothing accepted, the statistics applied all the same), so each
    dispatch handles one frame; the last K - 1 frames are a short tail
    for track().  The run equals the sequential one."""
    cfg = dict(CFG, kf_min_gap=1, kf_max_gap=1)
    n, K = 12, 4
    _, dt = datasets(n_frames=n)
    frames = list(dt)
    seq, _ = port_run(frames, dt.camera, cfg, batched=False)
    bat, poses = port_run(frames, dt.camera, dict(cfg, dispatch_batch=K),
                          batched=True)
    assert len(poses) == n
    assert_same_run(seq, bat)
    st = bat.timer.stats()
    # frame 0 bootstraps, frames 1 .. n - K one dispatch each, the rest
    # one track() call each
    assert st["slam/track_batch"]["count"] == n - K
    assert st["slam/track_fused"]["count"] == K - 1
    assert bat._n_frames_host == n
    assert int(bat.arena.point_visible.sum()) > 0


def test_batch_against_reference():
    dj, dt = datasets(n_frames=N_FRAMES)
    fj, ft = list(dj), list(dt)
    t = np.asarray([f.timestamp for f in ft])
    gt = np.stack([f.gt_pose[:3] for f in ft])
    cfg_b = dict(CFG, dispatch_batch=4)
    js = JSLAM(dj.camera, JConfig(**cfg_b))
    js.track_batch(fj)
    ate_j = j_eval(t, js.positions(), t, gt, with_scale=False).ate_rmse
    seq = KeyframeSLAM(dt.camera, SLAMConfig(**CFG), device="cpu")
    for f in ft:
        seq.track(f)
    bat = KeyframeSLAM(dt.camera, SLAMConfig(**cfg_b), device="cpu")
    poses = bat.track_batch(ft)
    assert len(poses) == N_FRAMES
    for s in (js, bat):
        assert len(s.trajectory) == len(s._traj_rel) == N_FRAMES
        assert len(s.timestamps) == len(s.stats) == N_FRAMES
    assert abs(bat._n_frames_host - js._n_frames_host) <= 1
    m_seq = evaluate_trajectory(t, seq.positions(), t, gt, with_scale=False)
    m_bat = evaluate_trajectory(t, bat.positions(), t, gt, with_scale=False)
    assert abs(m_bat.ate_rmse - ate_j) <= 0.01
    assert m_bat.ate_rmse < max(0.05, 2.0 * m_seq.ate_rmse + 0.01)
    assert bat.timer.stats().get("slam/track_batch") is not None
    # tests/test_slam_e2e.py::TestBatchedDispatch::test_batched_inserts_
    # keyframes
    assert int(bat.arena.n_frames) >= 2
    assert arena_stats(bat.arena)["valid_points"] > 50


class HostReads(TorchDispatchMode):
    """Records the operators that read a device value on the host (a
    0-d tensor as a Python number, a boolean mask's nonzero) or copy a
    host constant in: none of them can be captured in a CUDA graph."""

    HOST = ("aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero",
            "aten.masked_select", "aten.unique", "aten._unique",
            "aten.repeat_interleave")

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.HOST):
            self.found.append(name)
        if name.startswith(("aten.index.Tensor", "aten.index_put")):
            idx = args[1]
            if any(t is not None and t.dtype == torch.bool for t in idx):
                self.found.append(name + " with a boolean mask")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_batch_body_has_no_host_reads(use_kernels):
    cfg = dict(CFG, dispatch_batch=3, use_kernels=use_kernels)
    _, dt = datasets(n_frames=4)
    frames = list(dt)
    slam, _ = port_run(frames[:1], dt.camera, cfg, batched=False)
    slab_ids, xyz, desc, valid = slam._slab(slam.arena, "slam/track_batch")
    imgs = torch.stack([torch.as_tensor(f.image) for f in frames[1:]])
    x = slam._batch_inputs(imgs, torch.rand(3, 256, 4), xyz, desc, valid)
    with HostReads() as rec:
        res = slam._batch_body(x)
    assert rec.found == []
    assert res.rows[:, 18].all()


def replay_reference_cell(n_frames: int = 192, K: int = 8) -> dict:
    """The JAX package's ``track_batch`` over the full-system cell
    (tests/test_torch_slam.py's FULL_SEQUENCE, ``dispatch_batch`` K) with
    its draws recorded in the order it takes them (the K keys of each
    dispatch, a key per frame tracked one a call), and the port's
    ``track_batch`` over the same frames on the CPU with them replayed:
    both ATEs and keyframe counts, and the inlier counts."""
    import jax

    cfg = dict(FULL_CFG, dispatch_batch=K)
    ds = JData(**FULL_SEQUENCE)
    ds.open("synth://")
    frames = [ds.grab_frame() for _ in range(n_frames)]
    js = JSLAM(ds.camera, JConfig(**cfg))
    keys = []
    next_key = js._next_key

    def recorded_key():
        keys.append(next_key())
        return keys[-1]

    js._next_key = recorded_key
    build = js._build_batched_track

    def build_recorded(k):
        batched = build(k)

        def run(*args):
            keys.pop()                    # the dispatch's key, split in K
            keys.extend(args[-1])
            return batched(*args)

        return run

    js._build_batched_track = build_recorded
    js.track_batch(frames)
    dt = SyntheticDataset(**FULL_SEQUENCE)
    dt.open("synth://")
    draws = iter(torch.as_tensor(np.asarray(jax.random.uniform(k, (256, 4))))
                 for k in keys)
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**cfg), device="cpu",
                      uniforms=lambda: next(draws))
    ts.track_batch([dt.grab_frame() for _ in range(n_frames)])
    t = np.asarray([f.timestamp for f in frames])
    gt = np.stack([f.gt_pose[:3] for f in frames])
    return dict(
        jax=dict(ate_m=float(j_eval(t, js.positions(), t, gt,
                                    with_scale=False).ate_rmse),
                 keyframes=js._n_frames_host,
                 inliers=[s["n_inliers"] for s in js.stats]),
        port=dict(ate_m=float(evaluate_trajectory(t, ts.positions(), t, gt,
                                                  with_scale=False).ate_rmse),
                  keyframes=ts._n_frames_host,
                  inliers=[s["n_inliers"] for s in ts.stats],
                  frames_per_dispatch=ts.batch_accepted))


if __name__ == "__main__":
    import json
    import sys

    import jax

    if sys.argv[1:] != ["--replay-reference-cell"]:
        sys.exit("usage: python tests/test_torch_batch.py "
                 "--replay-reference-cell")
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    print(json.dumps(replay_reference_cell()))
