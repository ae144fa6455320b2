"""The port's FrameToFrameOdometry (gslam_tpu_torch.models.odometry)
against the JAX package's, on the 12-frame 192 x 144 ``line`` sequence
of tests/test_slam_e2e.py:31-74.

* Lockstep over the first LOCK_FRAMES frames: the port takes the JAX
  package's features of each frame (the frontends differ by an ulp in
  blur, which flips BRIEF bits on flat regions and so moves a few
  matches) and the JAX package's draws (its key chain, split once per
  RANSAC call), and the JAX package runs its PnP and two-view solvers
  op by op (``jax.disable_jit``): jitted, XLA fuses their float32
  arithmetic, which moves an ill-conditioned P3P hypothesis's inlier
  count and with it RANSAC's winner, by as much as the port does (on
  this sequence the jitted and the op-by-op JAX PnP differ by 1.4e-3 to
  0.09 in pose on 7 of 11 calls, the op-by-op one and the port's by at
  most 2.7e-3, and by under 4e-7 on 10 of them: ``python
  tests/test_torch_odometry.py --jit-spread``).  Match and inlier counts are then
  equal frame by frame, and the chained poses within 5e-3 (measured
  2.7e-3 in depth mode, from one RANSAC near-tie, and 5.5e-4 in mono
  mode, the homography decomposition's float32 conditioning of
  test_torch_init2view.py).
* End to end on the port's own extraction and draws: ATE under 0.10 m
  (tests/test_slam_e2e.py:64), at least 10 frames of 12 with 10 inliers
  (:66-72), in both modes (mono after Sim3 alignment); the registry.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.datasets.synthetic import SyntheticDataset as JData
from gslam_tpu.models import odometry as j_odometry
from gslam_tpu.models.odometry import FrameToFrameOdometry as JOdometry
from gslam_tpu.ops.frontend import extract_features as j_extract
from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.models import odometry
from gslam_tpu_torch.models.odometry import FrameToFrameOdometry
from tests.test_torch_slam import port_features

torch.set_num_threads(2)

N = 12
LOCK_FRAMES = 6
SMALL = dict(n_frames=N, n_points=300, width=192, height=144, motion="line",
             depth=True)
KW = dict(max_kps=192, fast_threshold=0.1)


def key_chain(kind: str, seed: int = 0):
    """The JAX odometry's draws, in order: each call splits the key
    once, as its ``_next_key`` does; a (256, 4) PnP draw, or the
    two-view pair (the key split into E and H halves)."""
    key = [jax.random.PRNGKey(seed)]

    def draws():
        key[0], sub = jax.random.split(key[0])
        if kind == "pnp":
            return torch.tensor(np.asarray(jax.random.uniform(sub, (256, 4))))
        ke, kh = jax.random.split(sub)
        return (torch.tensor(np.asarray(jax.random.uniform(ke, (256, 8)))),
                torch.tensor(np.asarray(jax.random.uniform(kh, (256, 4)))))

    return draws


def eager(fn):
    """``fn`` run op by op: XLA's fused (jitted) float32 arithmetic
    moves P3P and the two-view solvers by as much as the port does."""
    def call(*a, **k):
        with jax.disable_jit():
            return fn(*a, **k)
    return call


def jax_features(img, max_kps=512, threshold=0.06, use_kernels=True):
    return port_features(j_extract(jnp.asarray(img.numpy()), max_kps=max_kps,
                                   threshold=threshold, use_pallas=False))


def metrics(frames, positions, with_scale):
    t = np.asarray([fr.timestamp for fr in frames])
    gt = np.stack([fr.gt_pose[:3] for fr in frames])
    return evaluate_trajectory(t, positions, t, gt, with_scale=with_scale)


@pytest.fixture(scope="module", params=[True, False], ids=["depth", "mono"])
def lockstep(request):
    """Both packages over the first LOCK_FRAMES frames (with or without
    depth), the port on the JAX package's features and draws."""
    depth = request.param
    dj = JData(**dict(SMALL, n_frames=LOCK_FRAMES, depth=depth))
    dj.open("synth://")
    jo = JOdometry(dj.camera, **KW)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("find_pnp_ransac", "two_view_geometry"):
            mp.setattr(j_odometry, name, eager(getattr(j_odometry, name)))
        for fr in dj:
            jo.track(fr)
    dt = SyntheticDataset(**dict(SMALL, n_frames=LOCK_FRAMES, depth=depth))
    dt.open("synth://")
    frames = list(dt)
    to = FrameToFrameOdometry(dt.camera, **KW, device="cpu",
                              uniforms=key_chain("pnp" if depth else "tv"))
    with contextlib.ExitStack() as stack:
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        mp.setattr(odometry, "extract_features", jax_features)
        for fr in frames:
            to.track(fr)
    return depth, jo, to


def test_lockstep_matches_inliers_and_poses(lockstep):
    depth, jo, to = lockstep
    assert [s["n_matches"] for s in to.stats] == \
        [s["n_matches"] for s in jo.stats]
    assert [s["n_features"] for s in to.stats] == \
        [s["n_features"] for s in jo.stats]
    n_j = [s["n_inliers"] for s in jo.stats]
    assert [s["n_inliers"] for s in to.stats] == n_j and min(n_j[1:]) > 50
    T_j = np.stack(jo.trajectory)
    T_t = torch.stack(to.trajectory).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=5e-3)


@pytest.mark.parametrize("depth", [True, False], ids=["depth", "mono"])
def test_end_to_end_ate_and_tracked_frames(depth):
    ds = SyntheticDataset(**dict(SMALL, depth=depth))
    ds.open("synth://")
    frames = list(ds)
    odom = FrameToFrameOdometry(ds.camera, **KW, device="cpu")
    for fr in frames:
        odom.track(fr)
    m = metrics(frames, odom.positions(), with_scale=not depth)
    assert m.n_matched == N
    assert m.ate_rmse < 0.10
    assert sum(s["n_inliers"] >= 10 for s in odom.stats) >= N - 2
    assert len(odom.timestamps) == N
    assert set(odom.timer.stats()) >= {"odom/extract", "odom/match"}


def test_registry_creates_odometry():
    ds = SyntheticDataset(**dict(SMALL, n_frames=2))
    ds.open("synth://")
    s = SLAMS.create("odometry", ds.camera, device="cpu", **KW)
    assert isinstance(s, FrameToFrameOdometry)
    for fr in ds:
        pose = s.track(fr)
    assert pose.shape == (7,) and s.stats[1]["n_inliers"] >= 10


def test_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ds = SyntheticDataset(**dict(SMALL, n_frames=1))
    ds.open("synth://")
    with pytest.raises(RuntimeError, match="cuda"):
        SLAMS.create("odometry", ds.camera)


def jit_spread() -> None:
    """Per PnP call of the JAX odometry over the 12-frame sequence: the
    inlier counts of its jitted call, the same call op by op and the
    port's on the same inputs and draws, and the largest pose
    differences (jitted - op by op, op by op - port)."""
    from gslam_tpu.estimation import pnp as j_pnp
    from gslam_tpu_torch.estimation import pnp as t_pnp

    calls = []
    solve = j_odometry.find_pnp_ransac

    def recorded(key, pts, rays, ok, threshold):
        out = solve(key, pts, rays, ok, threshold=threshold)
        calls.append((key, pts, rays, ok, threshold, out))
        return out

    dj = JData(**SMALL)
    dj.open("synth://")
    jo = JOdometry(dj.camera, **KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_odometry, "find_pnp_ransac", recorded)
        for fr in dj:
            jo.track(fr)
    for k, (key, pts, rays, ok, thr, (T, _, n)) in enumerate(calls):
        with jax.disable_jit():
            Te, _, ne = j_pnp.find_pnp_ransac(key, pts, rays, ok,
                                              threshold=thr)
        Tt, _, nt = t_pnp.find_pnp_ransac(
            torch.tensor(np.asarray(pts)), torch.tensor(np.asarray(rays)),
            torch.tensor(np.asarray(ok)), threshold=thr,
            uniforms=torch.tensor(np.asarray(jax.random.uniform(key,
                                                                (256, 4)))))
        print(f"call {k}: inliers jitted {int(n)}, op by op {int(ne)}, port "
              f"{int(nt)}; pose jitted - op by op "
              f"{np.abs(np.asarray(T) - np.asarray(Te)).max():.3g}, op by op"
              f" - port {np.abs(np.asarray(Te) - Tt.numpy()).max():.3g}")


if __name__ == "__main__":
    import sys

    if sys.argv[1:] != ["--jit-spread"]:
        sys.exit("usage: python tests/test_torch_odometry.py --jit-spread")
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    jit_spread()
