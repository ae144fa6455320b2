"""The covisibility slab's reuse of its point ids
(``KeyframeSLAM._slab``), on 192 x 144 synthetic sequences on the CPU.

* Every ``_slab`` call's ids equal a fresh ``covis_union_ids`` on the
  same arena, bit for bit, and a run whose cache is emptied before every
  call gives the same poses, ``_last_track``, stats and arena, bit for
  bit: RGB-D with several keyframes, ``track_batch``, the monocular
  bootstrap and a ``StereoSLAM`` episode.
* Each way the ids' inputs change (the arena functions that write the
  observations or the frames, ``last_kf_id`` alone, an in-place write)
  makes the next call a miss that equals the recomputation; the call
  after it hits again.
* Counter ``slam/track_fused/slab_hit``: one observation a tracked
  frame, a hit on each frame but the first tracked after a keyframe
  insertion.
"""

import pytest
import torch

from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.map.arena import (
    add_observations, compact_arena, covis_union_ids, cull_by_found_ratio,
    erase_frame, erase_points, insert_frame,
)
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM
from gslam_tpu_torch.ops.cuda.graphs import tensor_leaves

torch.set_num_threads(2)

SEQ = dict(n_frames=14, n_points=300, width=192, height=144, motion="line",
           depth=True)
CFG = dict(max_kps=192, fast_threshold=0.1, ba_window=4, ba_points=256,
           ba_iters=3, cap_frames=32, cap_points=2048, cap_obs=8192,
           local_map_size=384, kf_max_gap=3)
RUNS = {
    "rgbd": (dict(SEQ), dict(CFG), "keyframe", False),
    "batch": (dict(SEQ, n_frames=18), dict(CFG, kf_max_gap=5,
                                           dispatch_batch=4),
              "keyframe", True),
    "mono": (dict(SEQ, n_frames=20, depth=False),
             dict(CFG, kf_min_gap=2, kf_max_gap=5), "keyframe", False),
    "stereo": (dict(SEQ, depth=False, stereo=True, baseline=0.3,
                    n_points=400), dict(CFG), "stereo", False),
}


def fresh_ids(slam, arena):
    """``covis_union_ids`` of the last keyframe, computed anew."""
    c = slam.cfg
    return covis_union_ids(
        arena, torch.tensor(slam.last_kf_id, dtype=torch.int32),
        c.local_map_size, window=min(c.ba_window, c.cap_frames - 1),
        min_common=5)


@pytest.fixture
def recorded(monkeypatch):
    """``_slab`` wrapped: each call's ids held against :func:`fresh_ids`
    (``calls``: (span, hit, equal)); the cache emptied first where
    ``mode["clear"]``."""
    slab = KeyframeSLAM._slab
    calls, mode = [], {"clear": False}

    def wrapped(self, arena, span):
        if mode["clear"]:
            self._slab_cache = None
        before = self._slab_cache
        out = slab(self, arena, span)
        ids = self._slab_cache[2]
        hit = self._slab_cache is before
        calls.append((span, hit, torch.equal(ids, fresh_ids(self, arena))
                      and torch.equal(out[0], ids.clamp_min(0).long())))
        return out

    monkeypatch.setattr(KeyframeSLAM, "_slab", wrapped)
    return calls, mode


def episode(kind):
    seq, cfg, system, batched = RUNS[kind]
    ds = SyntheticDataset(**seq)
    ds.open("synth://")
    slam = SLAMS.create(system, ds.camera, device="cpu", **cfg)
    frames = list(ds)
    if batched:
        slam.track_batch(frames)
    else:
        for fr in frames:
            slam.track(fr)
    return slam


def assert_same(a, b):
    assert torch.equal(torch.stack(a.trajectory), torch.stack(b.trajectory))
    assert [k for k, _ in a._traj_rel] == [k for k, _ in b._traj_rel]
    assert torch.equal(torch.stack([r for _, r in a._traj_rel]),
                       torch.stack([r for _, r in b._traj_rel]))
    assert a.stats == b.stats and a.last_kf_id == b.last_kf_id
    assert a.batch_accepted == b.batch_accepted
    for (name, x), (_, y) in zip(a.arena.tensors(), b.arena.tensors()):
        assert torch.equal(x, y), name
    got, want = tensor_leaves(a._last_track), tensor_leaves(b._last_track)
    assert len(got) == len(want)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_reused_ids_change_nothing(kind, recorded):
    calls, mode = recorded
    cached = episode(kind)
    n_hits = sum(hit for _, hit, _ in calls)
    assert calls and all(eq for _, _, eq in calls)
    mode["clear"] = True
    del calls[:]
    cleared = episode(kind)
    assert all(eq and not hit for _, hit, eq in calls)
    assert cleared.initialized and cleared._n_frames_host >= 3
    assert_same(cached, cleared)
    # the runs took the cache's hits: the comparison is not vacuous
    assert n_hits >= 2


def _add_obs(slam):
    a = slam.arena
    ids = torch.nonzero(a.point_valid).flatten().to(torch.int32)[:16]
    slam.arena = add_observations(a, slam.last_kf_id, ids,
                                  torch.zeros_like(ids),
                                  torch.ones_like(ids, dtype=torch.bool))


def _insert_frame(slam):
    a = slam.arena
    slam.arena, _ = insert_frame(a, a.frame_pose[0], 0.0, a.frame_kp_uv[0],
                                 a.frame_kp_meta[0], a.frame_desc[0],
                                 a.frame_kp_count[0])


def _insert_frame_only(slam):
    fr = slam._prev_frame
    slam._insert_frame_only(fr, slam._prev_feats,
                            slam.arena.frame_pose[0][:7])


def _erase_points(slam):
    ids = slam._slab_cache[2]
    slam.arena = erase_points(slam.arena, ids[ids >= 0][:8])


def _obs_valid_in_place(slam):
    a = slam.arena
    p = slam._slab_cache[2][0]
    a.obs_valid[a.obs_point == p] = False


def _last_kf(slam):
    slam.last_kf_id = 0


CHANGES = {
    # name: (write, the ids must differ from the cached ones)
    "add_observations": (_add_obs, False),
    "insert_frame": (_insert_frame, False),
    "_insert_frame_only": (_insert_frame_only, False),
    "erase_frame": (lambda s: setattr(s, "arena", erase_frame(
        s.arena, s.last_kf_id)), True),
    "erase_points": (_erase_points, True),
    "cull_by_found_ratio": (lambda s: setattr(s, "arena", cull_by_found_ratio(
        s.arena, min_visible=1, min_ratio=1.0)), False),
    "compact_arena": (lambda s: setattr(s, "arena", compact_arena(
        s.arena)[0]), False),
    "last_kf_id": (_last_kf, True),
    "obs_valid_in_place": (_obs_valid_in_place, True),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_changed_input_misses(change):
    ds = SyntheticDataset(**dict(SEQ, n_frames=20))
    ds.open("synth://")
    slam = SLAMS.create("keyframe", ds.camera, device="cpu", **CFG)
    for fr in ds:
        slam.track(fr)
    assert slam.last_kf_id > 0
    slam._slab_cache = None
    slam._slab(slam.arena, "t")                     # a miss
    before = slam._slab_cache
    slam._slab(slam.arena, "t")
    assert slam._slab_cache is before              # a hit
    write, differs = CHANGES[change]
    write(slam)
    ids = slam._slab(slam.arena, "t")[0]
    after = slam._slab_cache
    assert after is not before                      # a miss
    want = fresh_ids(slam, slam.arena)
    assert torch.equal(after[2], want)
    assert torch.equal(ids, want.clamp_min(0).long())
    if differs:
        assert not torch.equal(before[2], want)
    slam._slab(slam.arena, "t")
    assert slam._slab_cache is after                # a hit again
    st = slam.timer.stats()["t/slab_hit"]
    assert (st["count"], st["total"]) == (4, 2)


def test_hit_counter_counts_tracked_frames():
    ds = SyntheticDataset(**SEQ)
    ds.open("synth://")
    slam = SLAMS.create("keyframe", ds.camera, device="cpu", **CFG)
    tracked, after_kf, kf_before = 0, 0, None
    for fr in ds:
        was_init, n_kf = slam.initialized, slam._n_frames_host
        slam.track(fr)
        if was_init:
            tracked += 1
            after_kf += kf_before
        kf_before = slam._n_frames_host != n_kf
    st = slam.timer.stats()["slam/track_fused/slab_hit"]
    assert st["kind"] == "counter"
    assert st["count"] == tracked == len(slam.stats) - 1
    assert after_kf >= 3
    assert st["total"] == tracked - after_kf
