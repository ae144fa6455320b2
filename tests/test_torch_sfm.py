"""The port's global SfM (gslam_tpu_torch.models.sfm) against the JAX
package's (gslam_tpu/models/sfm.py), after tests/test_sfm.py.

* ``rotation_averaging`` on the synthetic view graphs of
  tests/test_sfm.py:41-81 (clean and noisy edges), both packages on the
  same numpy input: the global rotations agree up to the gauge (eigh's
  eigenvectors are free up to a rotation Q, so R_i R_0^T is compared),
  within 1e-5 (measured 6.1e-7), and meet the reference test's gates.
* ``translation_recovery`` (host numpy in both) on the graphs of
  tests/test_sfm.py:84-113: the same centres to 1e-9 (measured equal).
* ``_edge_direction`` (one edge and all edges at once) and
  ``reprojection_errors`` on the same inputs: within 1e-6, equal
  support counts.
* ``_build_tracks`` on the pair geometry of a port run: the same
  observation tables, masks and cameras, and points within 1e-4 of the
  JAX package's triangulation.
* The 10-frame 256 x 192 orbit of tests/test_sfm.py:116-140 through the
  port with the JAX package's pair draws replayed (``split(key)``, then
  ``split(sub, len(chunk))`` a chunk): at least 9 edges and ATE under
  0.30 m after Sim3 alignment.  With its own draws the port's run turns
  on them, as the JAX package's does: over seeds 0-7 each has one run
  above 1 m (the port seed 0, 1.14 m; the JAX package seed 3, 1.27 m),
  the others 0.034-0.19 m (``python tests/test_torch_sfm.py
  --seed-spread small``).
* ``finalize`` is cached and ``track`` resets it (:137-150); the
  registry (:152) and the five systems' names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.app.registry import SLAMS as J_SLAMS
from gslam_tpu.models import sfm as js
from gslam_tpu.opt.ba import BundleProblem as JProblem
from gslam_tpu.opt.ba import reprojection_errors as j_reprojection_errors
from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.models import sfm as ts
from gslam_tpu_torch.opt.ba import BundleProblem, reprojection_errors
from tests.test_sfm import N_USE, SEQ, _all_edges, _rand_rotations

torch.set_num_threads(2)

KW = dict(max_kps=384, fast_threshold=0.08, min_pair_inliers=15,
          ba_iters=10)


def rotation_case(noisy: bool):
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(1 if noisy else 0)
    n = 8 if noisy else 10
    R_gt = _rand_rotations(rng, n)
    edges = _all_edges(n)
    R_rel = np.einsum("ekl,eml->ekm", R_gt[edges[:, 1]], R_gt[edges[:, 0]])
    if noisy:
        noise = Rotation.from_rotvec(
            0.02 * rng.randn(len(edges), 3)).as_matrix()
        R_rel = np.einsum("ekl,elm->ekm", noise, R_rel)
    return R_gt, edges, R_rel.astype(np.float32)


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_rotation_averaging_against_reference(noisy):
    R_gt, edges, R_rel = rotation_case(noisy)
    n = len(R_gt)
    w = np.ones(len(edges))
    R_t = ts.rotation_averaging(edges, R_rel, w, n)
    R_j = np.asarray(js.rotation_averaging(edges, R_rel, w, n))
    assert R_t.shape == (n, 3, 3) and R_t.dtype == np.float32
    gauge_t = np.einsum("ikl,ml->ikm", R_t, R_t[0])
    gauge_j = np.einsum("ikl,ml->ikm", R_j, R_j[0])
    np.testing.assert_allclose(gauge_t, gauge_j, atol=1e-5)
    for (i, j), Rr in zip(edges, R_rel):
        rel = R_t[j] @ R_t[i].T
        if noisy:
            rel_gt = R_gt[j] @ R_gt[i].T
            assert np.arccos(np.clip((np.trace(rel @ rel_gt.T) - 1) / 2,
                                     -1, 1)) < 0.08
        else:
            assert np.abs(rel - Rr).max() < 1e-3


@pytest.mark.parametrize("seed,n", [(2, 8), (3, 6)])
def test_translation_recovery_against_reference(seed, n):
    rng = np.random.RandomState(seed)
    c_gt = rng.randn(n, 3)
    c_gt -= c_gt[0]
    edges = _all_edges(n)
    d = c_gt[edges[:, 0]] - c_gt[edges[:, 1]]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w = np.ones(len(edges))
    c_t = ts.translation_recovery(edges, d, w, n)
    np.testing.assert_allclose(c_t, js.translation_recovery(edges, d, w, n),
                               atol=1e-9)
    s = np.linalg.norm(c_gt) / np.linalg.norm(c_t)
    assert np.abs(c_t * s - c_gt).max() < 1e-4


def edge_case(rng, K=256):
    """One edge: a relative motion, K rays in both views (z = 1) with
    noise, a mask (as the pipeline hands it the inlier matches)."""
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec(rng.normal(0, 0.1, 3)).as_matrix()
    t = rng.normal(0, 1, 3)
    t /= np.linalg.norm(t)
    X = np.stack([rng.uniform(-2, 2, K), rng.uniform(-2, 2, K),
                  rng.uniform(4, 8, K)], -1)
    Y = X @ R.T + 0.3 * t
    x1 = X / X[:, 2:3]
    x2 = Y / Y[:, 2:3]
    x2[:, :2] += rng.normal(0, 1e-3, (K, 2))
    ok = rng.uniform(size=K) > 0.1
    return (R.astype(np.float32), x1.astype(np.float32),
            x2.astype(np.float32), ok, t)


def test_edge_direction_against_reference():
    rng = np.random.default_rng(0)
    cases = [edge_case(rng) for _ in range(5)]
    for R, x1, x2, ok, t_true in cases:
        tj, cj = js._edge_direction(jnp.asarray(R), jnp.asarray(x1),
                                    jnp.asarray(x2), jnp.asarray(ok))
        tt, ct = ts._edge_direction(torch.as_tensor(R), torch.as_tensor(x1),
                                    torch.as_tensor(x2), torch.as_tensor(ok))
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
        assert int(ct) == int(cj) > 100
        assert np.dot(tt.numpy(), t_true) > 0.99
    stack = [np.stack(a) for a in zip(*(c[:4] for c in cases))]
    tv, cv = ts._edge_directions(*(torch.as_tensor(a) for a in stack))
    tjv, cjv = js._edge_directions_v(*(jnp.asarray(a) for a in stack))
    np.testing.assert_allclose(tv.numpy(), np.asarray(tjv), atol=1e-6)
    np.testing.assert_array_equal(cv.numpy(), np.asarray(cjv))


def test_reprojection_errors_against_reference():
    rng = np.random.default_rng(3)
    C, P, O = 5, 64, 6
    q = rng.normal(size=(C, 4))
    q[:, 0] += 4.0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    fields = dict(
        cam_pose=np.concatenate([rng.normal(0, 0.3, (C, 3)), q], 1),
        cam_fixed=np.arange(C) == 0,
        point_xyz=np.concatenate([rng.uniform(-2, 2, (P, 2)),
                                  rng.uniform(-1, 6, (P, 1))], 1),
        point_fixed=np.zeros(P, bool),
        obs_cam=rng.integers(0, C, (P, O)),
        obs_uv=rng.normal(0, 0.3, (P, O, 2)),
        obs_valid=rng.uniform(size=(P, O)) > 0.2,
        obs_weight=np.ones((P, O)))
    cast = {k: (v.astype(np.float32) if v.dtype == np.float64 else
                v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in fields.items()}
    e_j, v_j = j_reprojection_errors(JProblem(**{
        k: jnp.asarray(v) for k, v in cast.items()}))
    e_t, v_t = reprojection_errors(BundleProblem(**{
        k: torch.as_tensor(v) for k, v in cast.items()}))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert 0 < int(v_t.sum()) < P * O     # some points behind a camera
    np.testing.assert_allclose(e_t.numpy()[v_t.numpy()],
                               np.asarray(e_j)[np.asarray(v_j)], atol=1e-6,
                               rtol=1e-6)


class ReplayDraws:
    """The JAX GlobalSfM's pair draws: per chunk ``split(key)``, then
    ``split(sub, len(chunk))``, each pair's key split into the E and H
    halves of its two-view call."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, n: int):
        self.key, sub = jax.random.split(self.key)
        out = []
        for k in jax.random.split(sub, n):
            ke, kh = jax.random.split(k)
            out.append((torch.tensor(np.asarray(jax.random.uniform(
                ke, (256, 8)))), torch.tensor(np.asarray(
                    jax.random.uniform(kh, (256, 4))))))
        return out


@pytest.fixture(scope="module")
def orbit():
    ds = SyntheticDataset(**SEQ)
    ds.open("synth://")
    return ds.camera, [fr for _, fr in zip(range(N_USE), ds)]


@pytest.fixture(scope="module")
def pipeline(orbit):
    """The port's pipeline over the orbit with the JAX package's draws,
    ``_build_tracks``'s arguments recorded."""
    cam, frames = orbit
    sfm = ts.GlobalSfM(cam, **KW, device="cpu", uniforms=ReplayDraws())
    recorded = []
    build = sfm._build_tracks

    def recording(*args):
        recorded.append(args)
        return build(*args)

    sfm._build_tracks = recording
    for fr in frames:
        sfm.track(fr)
    return sfm, sfm.finalize(), recorded[0]


def test_pipeline_with_reference_draws(orbit, pipeline):
    _, frames = orbit
    sfm, res, _ = pipeline
    assert res["n_frames"] == N_USE
    assert res["n_edges"] >= N_USE - 1
    t = np.asarray([fr.timestamp for fr in frames])
    gt = np.stack([fr.gt_pose[:3] for fr in frames])
    m = evaluate_trajectory(t, sfm.positions(), t, gt, with_scale=True)
    assert m.ate_rmse < 0.30
    assert len(res["points"]) > 0 and np.isfinite(res["points"]).all()
    assert len(sfm.trajectory) == N_USE and sfm.timestamps == list(t)
    assert set(sfm.timer.stats()) == {
        "sfm/extract", "sfm/pairs", "sfm/rotations", "sfm/translations",
        "sfm/tracks", "sfm/global_ba"}
    assert sfm.ba_costs[-1] < sfm.ba_costs[0]
    assert sfm.ba_problem.cam_pose.shape[0] == N_USE


def test_build_tracks_against_reference(orbit, pipeline):
    cam, _ = orbit
    _, _, (poses_cw, rays, G, pairs, keep) = pipeline
    jsfm = js.GlobalSfM(cam, **KW)
    jp = jsfm._build_tracks(poses_cw, jnp.asarray(rays),
                            js.PairGeometry(*G), pairs, keep)
    tp = ts.GlobalSfM(cam, **KW, device="cpu")._build_tracks(
        poses_cw, rays, G, pairs, keep)
    for name in ("cam_pose", "cam_fixed", "point_fixed", "obs_cam",
                 "obs_uv", "obs_valid", "obs_weight"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    np.testing.assert_allclose(tp.point_xyz.numpy(), np.asarray(jp.point_xyz),
                               atol=1e-4, rtol=1e-5)
    assert int(tp.obs_valid.sum()) > 500


def test_finalize_is_cached_and_track_resets(orbit):
    cam, frames = orbit
    sfm = ts.GlobalSfM(cam, **dict(KW, ba_iters=2), device="cpu")
    for fr in frames[:4]:
        sfm.track(fr)
    with pytest.raises(ValueError):
        ts.GlobalSfM(cam, device="cpu").finalize()
    r1 = sfm.finalize()
    assert sfm.finalize() is r1
    sfm.track(frames[4])
    assert sfm._result is None


def test_registry(orbit):
    import gslam_tpu.models.direct  # noqa: F401  (fill the JAX registry)
    import gslam_tpu.models.sfm  # noqa: F401
    import gslam_tpu.models.stereo  # noqa: F401

    cam, _ = orbit
    s = SLAMS.create("sfm", cam, device="cpu")
    assert isinstance(s, ts.GlobalSfM)
    assert SLAMS.names() == J_SLAMS.names() == [
        "direct", "keyframe", "odometry", "sfm", "stereo"]
    if not torch.cuda.is_available():
        for name in SLAMS.names():
            with pytest.raises(RuntimeError, match="cuda"):
                SLAMS.create(name, cam)


def seed_spread(size: str, seeds=range(8)) -> None:
    """Both packages' GlobalSfM over the orbit with seeds ``seeds``: the
    test's 256 x 192 scene (``small``), or chip_smoke.py's 640 x 480 SfM
    cell, 1200 points and ``max_kps`` 512 (``full``); edges
    and ATE after Sim3 alignment per seed, CPU."""
    import logging

    from gslam_tpu.datasets.synthetic import SyntheticDataset as JData
    from gslam_tpu.eval import evaluate_trajectory as j_eval

    seq, kw = dict(SEQ), dict(KW)
    if size == "full":
        seq.update(width=640, height=480, n_points=1200)
        kw.update(max_kps=512)
    logging.getLogger("gslam_tpu").setLevel("WARNING")
    logging.getLogger("gslam_tpu_torch").setLevel("WARNING")
    dj = JData(**seq)
    dj.open("synth://")
    fj = [fr for _, fr in zip(range(N_USE), dj)]
    dt = SyntheticDataset(**seq)
    dt.open("synth://")
    ft = [fr for _, fr in zip(range(N_USE), dt)]
    t = np.asarray([fr.timestamp for fr in fj])
    gt = np.stack([fr.gt_pose[:3] for fr in fj])
    for seed in seeds:
        j = js.GlobalSfM(dj.camera, **kw, seed=seed)
        p = ts.GlobalSfM(dt.camera, **kw, seed=seed, device="cpu")
        for sj, st in zip(fj, ft):
            j.track(sj)
            p.track(st)
        rj, rp = j.finalize(), p.finalize()
        print(f"seed {seed}: JAX {rj['n_edges']} edges, ATE "
              f"{j_eval(t, j.positions(), t, gt, with_scale=True).ate_rmse:.6f}"
              f" m; port {rp['n_edges']} edges, ATE "
              f"{evaluate_trajectory(t, p.positions(), t, gt, with_scale=True).ate_rmse:.6f}"
              " m", flush=True)


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 3 or sys.argv[1] != "--seed-spread" \
            or sys.argv[2] not in ("small", "full"):
        sys.exit("usage: python tests/test_torch_sfm.py --seed-spread "
                 "small|full")
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    seed_spread(sys.argv[2])
