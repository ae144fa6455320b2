"""The port's direct odometry (gslam_tpu_torch.models.direct) against the
JAX package's, on the 192 x 144 ``line`` sequence of
tests/test_slam_e2e.py:328-418.

* ``_gradients``, ``_level_intrinsics`` and ``_bilinear`` are bit for
  bit the JAX package's; ``_select_points`` picks the same pixels (ties
  to the lowest index, ``_topk_stable``, where ``torch.topk`` would not
  promise it) and lifts them to points within an ulp (jitted, XLA
  divides by the constant focal length as a multiplication by its
  float32 reciprocal; the port divides), and the keyframe's reference
  intensities follow within 5e-6 (measured 1.5e-6); the per-level depth resize
  (``nearest-exact``) is bit for bit ``jax.image.resize(...,
  "nearest")``, where ``mode="nearest"`` is not.
* One ``_align_level`` call on identical inputs (the JAX package's
  pyramid and keyframe slab of frames 0 and 1), with and without the
  depth residual: the pose within 1e-5 (measured 1.9e-7: XLA fuses the
  jitted GN arithmetic and sums the normal equations in another order)
  and the valid fraction equal.
* The textureless case of tests/test_slam_e2e.py:341-406: the depth
  residual alone recovers a small motion.
* The 12-frame run with ``DirectConfig(n_points=512, n_levels=3,
  gn_iters=12)``: ATE under 0.10 m (the JAX test's gate), the same
  valid fractions frame by frame and the trajectory within 1e-5 of the
  JAX run's (measured 5.5e-7: the port's blur and pyramid differ from
  the JAX package's by an ulp and 2e-6, ROADMAP Queue C, and that moves
  the poses by less than a micrometre over 36 GN steps a frame).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gslam_tpu.core.se3 import se3_identity as j_se3_identity
from gslam_tpu.datasets.synthetic import SyntheticDataset as JData
from gslam_tpu.models import direct as jd
from gslam_tpu.ops.frontend import _bilinear as j_bilinear
from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.core.se3 import se3_apply, se3_identity
from gslam_tpu_torch.datasets.synthetic import SyntheticDataset
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.models import direct as td
from gslam_tpu_torch.ops.frontend import _bilinear
from tests.test_torch_slam import SMALL, run

torch.set_num_threads(2)

N = SMALL["n_frames"]
RUN_CFG = dict(n_points=512, n_levels=3, gn_iters=12)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def frames():
    ds = JData(**SMALL)
    ds.open("synth://")
    return ds.camera, list(ds)


@pytest.fixture(scope="module")
def keyframe(frames):
    """The JAX package's pyramid of frames 0 and 1 and its keyframe slab
    on frame 0 (DirectConfig defaults)."""
    cam, fr = frames
    jo = jd.DirectOdometry(cam)
    pyr0 = jo._pyramid(fr[0].image)
    jo._make_keyframe(fr[0], pyr0)
    pyr1 = jo._pyramid(fr[1].image)
    return jo, pyr0, pyr1


def test_gradients_and_level_intrinsics_bit_for_bit(keyframe, frames):
    cam, _ = frames
    _, pyr0, _ = keyframe
    for lvl in pyr0:
        for a, b in zip(td._gradients(t(lvl)), jd._gradients(lvl)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert td._level_intrinsics(cam, tuple(lvl.shape), pyr0[0].shape) \
            == jd._level_intrinsics(cam, lvl.shape, pyr0[0].shape)


def test_bilinear_bit_for_bit():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    # inside, on the border, past it (clamped) and at integer pixels
    x = np.concatenate([rng.uniform(-3, 56, 400), np.arange(-1, 54)]
                       ).astype(np.float32)
    y = np.concatenate([rng.uniform(-3, 40, 400), np.arange(-1, 54) % 38]
                       ).astype(np.float32)
    got = _bilinear(t(img), t(x), t(y)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_bilinear(
        jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))))


def pixels(X, fx, fy, cx, cy):
    """The (u, v) pixel each point was lifted from."""
    X = np.asarray(X, np.float64)
    return np.round(np.stack([X[:, 0] / X[:, 2] * fx + cx,
                              X[:, 1] / X[:, 2] * fy + cy], -1))


def test_select_points_and_reference_samples(keyframe, frames):
    cam, fr = frames
    jo, pyr0, _ = keyframe
    c = jo.cfg
    intr = (cam.fx, cam.fy, cam.cx, cam.cy)
    X, ok = td._select_points(t(pyr0[0]), t(fr[0].depth), c.n_points,
                              c.min_depth, c.max_depth, *intr)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jo.kf_valid))
    assert int(ok.sum()) == c.n_points
    np.testing.assert_array_equal(pixels(X.numpy(), *intr),
                                  pixels(jo.kf_X, *intr))
    np.testing.assert_allclose(X.numpy(), np.asarray(jo.kf_X), rtol=2e-7,
                               atol=0)
    # the keyframe's per-level reference intensities from the same
    # pyramid
    to = td.DirectOdometry(cam, device="cpu")
    to._make_keyframe(t(fr[0].depth), [t(lvl) for lvl in pyr0])
    for a, b in zip(to.kf_refs, jo.kf_refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-6)


def test_select_points_ties_go_to_the_lowest_index():
    img = np.zeros((24, 32), np.float32)
    img[:, 16:] = 1.0          # one vertical edge: equal gradients
    depth = np.full_like(img, 2.0)
    intr = (30.0, 30.0, 16.0, 12.0)
    X, ok = td._select_points(t(img), t(depth), 40, 0.05, 1e3, *intr)
    Xj, okj = jd._select_points(jnp.asarray(img), jnp.asarray(depth), 40,
                                0.05, 1e3, *intr)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(pixels(X.numpy(), *intr),
                                  pixels(Xj, *intr))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=2e-7, atol=0)


@pytest.mark.parametrize("shape", [(72, 96), (36, 48), (48, 64), (29, 41)])
def test_nearest_depth_resize_bit_for_bit(shape):
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 5.0, (144, 192)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.05] = np.nan
    ref = np.asarray(jax.image.resize(jnp.asarray(depth), shape, "nearest"))
    np.testing.assert_array_equal(td._resize_nearest(t(depth), shape).numpy(),
                                  ref)
    arange = np.arange(144 * 192, dtype=np.float32).reshape(144, 192)
    ref = np.asarray(jax.image.resize(jnp.asarray(arange), shape, "nearest"))
    np.testing.assert_array_equal(
        td._resize_nearest(t(arange), shape).numpy(), ref)
    plain = F.interpolate(t(arange)[None, None], size=shape,
                          mode="nearest")[0, 0].numpy()
    assert not np.array_equal(plain, ref)


@pytest.mark.parametrize("use_depth", [False, True])
def test_align_level_against_reference(keyframe, frames, use_depth):
    cam, fr = frames
    jo, pyr0, pyr1 = keyframe
    c = jo.cfg
    li = 1
    lvl = pyr1[li]
    fxl, fyl, cxl, cyl = jd._level_intrinsics(cam, lvl.shape, pyr0[0].shape)
    dl = jax.image.resize(jnp.asarray(fr[1].depth), lvl.shape, "nearest")
    dgx, dgy = jd._gradients(dl)
    gx, gy = jd._gradients(lvl)
    args = dict(depth=dl, dgx=dgx, dgy=dgy) if use_depth else {}
    Tj, fj, ej = jd._align_level(
        lvl, gx, gy, jo.kf_X, jo.kf_refs[li], jo.kf_valid, j_se3_identity(),
        c.gn_iters, fxl, fyl, cxl, cyl, c.huber_delta,
        depth_weight=c.depth_weight, huber_d=c.huber_depth,
        use_depth=use_depth, **args)
    targs = {k: t(v) for k, v in args.items()}
    Tt, ft, et = td._align_level(
        t(lvl), t(gx), t(gy), t(jo.kf_X), t(jo.kf_refs[li]),
        t(jo.kf_valid), se3_identity(), c.gn_iters, fxl, fyl, cxl, cyl,
        c.huber_delta, depth_weight=c.depth_weight, huber_d=c.huber_depth,
        use_depth=use_depth, **targs)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
    assert float(ft) == float(fj) > 0.9
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-3)
    # a real motion was recovered (frame 1 moved from frame 0)
    assert np.abs(np.asarray(Tj[:3])).max() > 1e-3


def test_geometric_residual_textureless():
    """tests/test_slam_e2e.py:341-406: on a constant image the depth
    residual alone recovers a small motion (three planes with distinct
    normals constrain all six degrees of freedom)."""
    H, W = 96, 128
    fx = fy = 90.0
    cx, cy = W / 2, H / 2
    planes = [(np.array([0.0, 0.0, 1.0]), 4.0),
              (np.array([0.6, 0.0, 0.8]), 3.2),
              (np.array([0.0, 0.6, 0.8]), 3.4)]

    def render_depth(R_cw, t_cw):
        o = -R_cw.T @ t_cw
        uu, vv = np.meshgrid(np.arange(W), np.arange(H))
        rays = np.stack([(uu - cx) / fx, (vv - cy) / fy,
                         np.ones_like(uu, np.float64)], -1)
        dirs = rays @ R_cw
        z = np.full((H, W), np.inf)
        for n, d in planes:
            denom = dirs @ n
            s = (d - o @ n) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
            s = np.where((denom > 1e-6) & (s > 0.1), s, np.inf)
            z = np.minimum(z, s)
        return np.where(np.isfinite(z), z, 0.0).astype(np.float32)

    D_ref = render_depth(np.eye(3), np.zeros(3))
    ang = 0.01
    R_gt = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]])
    t_gt = np.array([0.04, -0.02, 0.03])
    D_cur = render_depth(R_gt, t_gt)
    uu, vv = np.meshgrid(np.arange(4, W - 4, 3), np.arange(4, H - 4, 3))
    z = D_ref[vv, uu].reshape(-1)
    ok = z > 0.1
    X = np.stack([(uu.reshape(-1) - cx) / fx * z,
                  (vv.reshape(-1) - cy) / fy * z, z], -1).astype(np.float32)
    img = torch.full((H, W), 0.5)
    zero = torch.zeros((H, W))
    dgx = t(np.gradient(D_cur, axis=1).astype(np.float32))
    dgy = t(np.gradient(D_cur, axis=0).astype(np.float32))
    T, frac, err = td._align_level(
        img, zero, zero, t(X), torch.full((X.shape[0],), 0.5), t(ok),
        se3_identity(), 15, fx, fy, cx, cy, 0.08, depth=t(D_cur), dgx=dgx,
        dgy=dgy, depth_weight=10.0, huber_d=0.1, use_depth=True)
    Xc = se3_apply(T, t(X[ok])).numpy()
    Xc_gt = X[ok] @ R_gt.T + t_gt
    assert np.abs(T[:3].numpy() - t_gt).max() < 0.02
    assert np.linalg.norm(Xc - Xc_gt, axis=-1).mean() < 0.02


def test_singular_normal_equations_give_nan_without_raising():
    H = torch.zeros((6, 6))
    assert torch.isnan(td._solve_or_nan(H, torch.ones(6))).all()
    H = torch.eye(6) * 2.0
    np.testing.assert_allclose(td._solve_or_nan(H, torch.ones(6)).numpy(),
                               0.5)


def test_twelve_frame_run_against_reference(frames):
    cam, fr = frames
    jo = jd.DirectOdometry(cam, jd.DirectConfig(**RUN_CFG))
    run(jo, fr)
    ds = SyntheticDataset(**SMALL)
    ds.open("synth://")
    slam = SLAMS.create("direct", ds.camera, device="cpu", **RUN_CFG,
                        vocabulary=None, max_kps=99)   # unknown keys dropped
    assert isinstance(slam, td.DirectOdometry)
    ts, gt = run(slam, ds)
    m = evaluate_trajectory(ts, slam.positions(), ts, gt, with_scale=False)
    assert m.n_matched == N
    assert m.ate_rmse < 0.10
    np.testing.assert_allclose(torch.stack(slam.trajectory).numpy(),
                               np.stack(jo.trajectory), atol=1e-5)
    assert sum(s["n_inliers"] > 100 for s in slam.stats) >= N - 2
    assert [s["n_inliers"] for s in slam.stats] == \
        [s["n_inliers"] for s in jo.stats]
    assert set(slam.timer.stats()) == {
        "direct/pyramid", "direct/align", "direct/align/fetch",
        "direct/keyframe", "direct/inbounds", "direct/points",
        "direct/keyframes", "direct/lost"}
