"""The port's LoopCloser (gslam_tpu_torch.models.loop_closure) against
the JAX package's, on one map seen from both sides.

The port maps the ring of tests/test_loop_closure.py with its ten
revisit frames (192x144, 58 frames, no vocabulary, so nothing is closed
while mapping); the arena is carried into the JAX package through numpy
and both loop closers get the same vocabulary (trained once, k=6, L=2).
The JAX package's RANSAC keys are recorded and their (1024, 4) uniforms
replayed into the port, one per draw, in order.

Tolerances: database rows equal in their words and to 1e-6 in their
weights (a float32 normalization); detection gives the same candidates;
each verification logs the same match count and accept decision, inliers
within 2 and the pose to 1e-3 (float32 P3P and Gauss-Newton on both
sides, see test_torch_pnp.py); a closure builds the same edge list with
measurements to 1e-4 and weights to 1e-3 relative, and leaves keyframe
poses and map points within 1e-3 of the JAX package's after the pose
graph and the gated global BA.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.core.camera import Camera as JCamera
from gslam_tpu.map import arena as ja
from gslam_tpu.models import loop_closure as jlc
from gslam_tpu.ops import vocab as jv
from gslam_tpu_torch import convert
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.map import arena as ta
from gslam_tpu_torch.models import loop_closure as tlc
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.ops import vocab as tv
from gslam_tpu_torch.ops.frontend import extract_features
from tests.test_torch_arena import jfields

torch.set_num_threads(2)

KPS = 192
CFG = dict(max_kps=KPS, fast_threshold=0.1, ba_window=4, ba_points=256,
           ba_iters=3, cap_frames=64, cap_points=4096, cap_obs=16384,
           local_map_size=512, kf_max_gap=4)
MIN_INLIERS = max(12, KPS // 16)      # as KeyframeSLAM builds its closer


def ring_frames(n=48, revisit=0):
    ds = SyntheticDataset(n_frames=n, n_points=500, width=192, height=144,
                          motion="ring", depth=True, radius=6.0,
                          world_extent=5.0)
    ds.open("synth://")
    frames = list(ds)
    for j in range(revisit):
        frames.append(dataclasses.replace(frames[j], id=n + j,
                                          timestamp=(n + j) / 30.0))
    return frames


def ring_vocabulary():
    """(port vocabulary, JAX vocabulary): one tree, trained by the port
    from the first six frames' descriptors."""
    descs = []
    for fr in ring_frames(6):
        f = extract_features(torch.as_tensor(fr.image), max_kps=128,
                             threshold=0.1)
        descs.append(f.desc.numpy().view(np.uint32)[f.valid.numpy()])
    voc_t = tv.train_vocabulary(np.concatenate(descs), k=6, L=2, seed=0,
                                device="cpu")
    return voc_t, jax_vocabulary(voc_t)


def jax_vocabulary(voc_t):
    f = tv.vocabulary_to_numpy(voc_t)
    return jv.Vocabulary(jnp.asarray(f["node_desc"]),
                         jnp.asarray(f["word_weight"]), f["k"], f["L"])


class Replay:
    """Records the keys a JAX LoopCloser draws and hands their uniforms
    to the port in the same order."""

    def __init__(self, closer):
        self.keys, self.pos = [], 0
        draw = closer._next_key

        def recorded():
            self.keys.append(draw())
            return self.keys[-1]

        closer._next_key = recorded

    def __call__(self):
        key = self.keys[self.pos]
        self.pos += 1
        return torch.tensor(np.asarray(jax.random.uniform(key, (1024, 4))))

    def drained(self):
        return self.pos == len(self.keys)


class Side:
    def __init__(self):
        voc_t, voc_j = ring_vocabulary()
        frames = ring_frames(48, revisit=10)
        slam = KeyframeSLAM(frames[0].camera, SLAMConfig(**CFG),
                            device="cpu")
        for fr in frames:
            slam.track(fr)
        cam = frames[0].camera
        self.cam_t = cam
        self.cam_j = JCamera.pinhole(cam.width, cam.height, cam.fx, cam.fy,
                                     cam.cx, cam.cy)
        self.arena_t = slam.arena
        self.arena_j = ja.make_arena(
            CFG["cap_frames"], KPS, CFG["cap_points"], CFG["cap_obs"]
        ).replace(**{k: jnp.asarray(v) for k, v in
                     convert.arena_to_numpy(slam.arena).items()})
        self.F = int(slam.arena.n_frames)
        self.closer_j = jlc.LoopCloser(voc_j, CFG["cap_frames"],
                                       min_inliers=MIN_INLIERS, min_gap=3)
        self.replay = Replay(self.closer_j)
        self.closer_t = tlc.LoopCloser(voc_t, CFG["cap_frames"],
                                       min_inliers=MIN_INLIERS, min_gap=3,
                                       uniforms=self.replay)
        for kf in range(self.F):
            self.closer_j.add_keyframe(
                kf, self.arena_j.frame_desc[kf],
                jnp.arange(KPS) < self.arena_j.frame_kp_count[kf])
            self.closer_t.add_keyframe(
                kf, self.arena_t.frame_desc[kf],
                torch.arange(KPS) < self.arena_t.frame_kp_count[kf])

    def candidates(self, kf):
        """Detection on both sides; the JAX package's list after the
        lists were found equal."""
        row_j = ja.covisibility_row(self.arena_j, jnp.asarray(kf))
        row_t = ta.covisibility_row(self.arena_t, kf)
        np.testing.assert_array_equal(row_t.numpy(), np.asarray(row_j))
        cand_j = self.closer_j.detect(kf, covis_row=row_j)
        assert self.closer_t.detect(kf, covis_row=row_t) == cand_j
        return cand_j


@pytest.fixture(scope="module")
def side():
    return Side()


def test_database_rows_equal(side):
    assert side.F >= 8 and side.closer_t.n_kf == side.closer_j.n_kf == side.F
    np.testing.assert_array_equal(side.closer_t.bow_words.numpy(),
                                  side.closer_j.bow_words)
    np.testing.assert_allclose(side.closer_t.bow_weights.numpy(),
                               side.closer_j.bow_weights, atol=1e-6)
    assert (side.closer_j.bow_words[:side.F] >= 0).sum(1).min() > 5
    bow = side.closer_t.bow_of(2)
    np.testing.assert_allclose(
        side.closer_t.query(bow),
        side.closer_j.query(side.closer_j.bow_of(2)), atol=1e-6)
    assert side.closer_t.query(bow, 0).shape == (0,)


def test_add_keyframe_with_more_words_than_slots():
    """A frame with more distinct words than the 512 slots keeps the 512
    heaviest, normalized again, in word order, in both packages."""
    rng = np.random.default_rng(3)
    k, L, N = 10, 3, 1500
    nodes = rng.integers(0, 2 ** 32, (1111, 8), dtype=np.uint64).astype(
        np.uint32)
    weights = rng.uniform(0.5, 3.0, k ** L).astype(np.float32)
    voc_t = convert.vocabulary_from_numpy(nodes, weights, k, L, device="cpu")
    desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(
        np.uint32)
    valid = rng.random(N) < 0.95
    closer_j = jlc.LoopCloser(jax_vocabulary(voc_t), 2)
    closer_t = tlc.LoopCloser(voc_t, 2)
    closer_j.add_keyframe(1, jnp.asarray(desc), jnp.asarray(valid))
    closer_t.add_keyframe(1, convert.desc_from_numpy(desc, "cpu"),
                          torch.tensor(valid))
    words = closer_j.bow_words[1]
    assert (words >= 0).all() and (np.diff(words) > 0).all()   # it bound
    np.testing.assert_array_equal(closer_t.bow_words.numpy(),
                                  closer_j.bow_words)
    np.testing.assert_allclose(closer_t.bow_weights.numpy(),
                               closer_j.bow_weights, atol=1e-6)
    np.testing.assert_allclose(closer_t.bow_weights[1].sum().item(), 1.0,
                               atol=1e-5)
    assert closer_t.n_kf == closer_j.n_kf == 2


def test_detect_same_candidates(side):
    found = [side.candidates(kf) for kf in range(side.F)]
    assert found[:4] == [[], [], [], []]            # the temporal guard
    assert sum(len(c) for c in found) >= 6
    # top_k and an empty database
    assert len(side.closer_t.detect(side.F - 1, top_k=1)) <= 1
    assert tlc.LoopCloser(side.closer_t.voc, 4).detect(0) == []


def test_verify_in_lockstep(side):
    """Every detected candidate of every keyframe through both
    verifications, the JAX package's draws replayed."""
    accepted = 0
    for kf in range(4, side.F):
        for cand in side.candidates(kf):
            out_j = side.closer_j.verify(side.arena_j, side.cam_j, kf, cand)
            out_t = side.closer_t.verify(side.arena_t, side.cam_t, kf, cand)
            assert side.replay.drained()
            log_j, log_t = (side.closer_j.verify_log[-1],
                            side.closer_t.verify_log[-1])
            assert log_t[:2] == log_j[:2] == (kf, cand)
            assert log_t[3] == log_j[3] and log_t[4] == log_j[4]
            assert abs(log_t[2] - log_j[2]) <= 2
            assert (out_t is None) == (out_j is None)
            if out_j is not None:
                accepted += 1
                np.testing.assert_allclose(out_t[0].numpy(),
                                           np.asarray(out_j[0]), atol=1e-3)
                assert abs(out_t[1] - out_j[1]) <= 2
                np.testing.assert_allclose(
                    side.closer_t._last_loop_H, side.closer_j._last_loop_H,
                    rtol=2e-2, atol=1e-2)
    assert accepted >= 1 and len(side.closer_t.verify_log) >= 10


def test_close_in_lockstep(side, monkeypatch):
    """The first keyframe whose loop verifies: fusion, the pose graph
    (same edges) and the gated global BA on both sides."""
    graphs = {}
    for name, mod in (("j", jlc), ("t", tlc)):
        solve = mod.optimize_pose_graph

        def recording(g, *a, _name=name, _solve=solve, **kw):
            graphs[_name] = g
            return _solve(g, *a, **kw)

        monkeypatch.setattr(mod, "optimize_pose_graph", recording)
    closed_kf = None
    for kf in range(4, side.F):
        side.closer_j._last_closed_kf = side.closer_t._last_closed_kf = -100
        a_j, did_j = side.closer_j.close(side.arena_j, side.cam_j, kf,
                                         global_ba_iters=4)
        a_t, did_t = side.closer_t.close(side.arena_t, side.cam_t, kf,
                                         global_ba_iters=4)
        assert side.replay.drained() and did_t == did_j
        if did_j:
            closed_kf = kf
            break
        np.testing.assert_array_equal(a_t.frame_pose.numpy(),
                                      side.arena_t.frame_pose.numpy())
    assert closed_kf is not None
    assert side.closer_t.closed == side.closer_j.closed
    assert side.closer_t.closed[-1][0] == closed_kf
    # within the cooldown nothing is closed again
    assert not side.closer_t.close(a_t, side.cam_t, closed_kf + 1)[1]

    g_j, g_t = graphs["j"], graphs["t"]
    for name in ("fixed", "edge_i", "edge_j", "edge_valid"):
        np.testing.assert_array_equal(getattr(g_t, name).numpy(),
                                      np.asarray(getattr(g_j, name)), name)
    n_edges = int(g_t.edge_valid.sum())
    assert n_edges >= side.F and g_t.poses.shape[0] == 64
    assert (int(g_t.edge_i[n_edges - 1]), int(g_t.edge_j[n_edges - 1])) \
        == side.closer_t.closed[-1]
    np.testing.assert_allclose(g_t.poses.numpy(), np.asarray(g_j.poses),
                               atol=1e-6)
    np.testing.assert_allclose(g_t.edge_rel.numpy(),
                               np.asarray(g_j.edge_rel), atol=1e-4)
    np.testing.assert_allclose(g_t.edge_weight.numpy(),
                               np.asarray(g_j.edge_weight), rtol=1e-3,
                               atol=1e-5)

    f_j, f_t = jfields(a_j), convert.arena_to_numpy(a_t)
    for name in ("n_obs", "obs_frame", "obs_point", "obs_kp", "obs_valid",
                 "point_valid"):
        np.testing.assert_array_equal(f_t[name], f_j[name], name)
    np.testing.assert_allclose(f_t["frame_pose"], f_j["frame_pose"],
                               atol=1e-3)
    np.testing.assert_allclose(f_t["point_xyz"], f_j["point_xyz"],
                               atol=1e-3)
    moved = np.abs(f_t["frame_pose"][:side.F, :3]
                   - side.arena_t.frame_pose[:side.F, :3].numpy()).max()
    assert moved > 0.05                    # the correction did something
    assert int(a_t.n_obs) > int(side.arena_t.n_obs)     # loop fusion


def test_imu_edges_are_not_ported(side):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        side.closer_t.close(side.arena_t, side.cam_t, 5,
                            imu_edges=[(0, 1, np.ones(4, np.float32))])
