"""Gold tests of the port's two-view geometry (gslam_tpu_torch.estimation
.epipolar, .homography, .init2view and pnp._dlt_pnp) against the JAX
package's, on the cases of tests/test_init2view.py and
tests/test_estimation.py.

Both packages get the same inputs, made with numpy from a seed, and the
port gets the JAX package's RANSAC draws: ``jax.random.uniform`` of the
keys the reference splits (E then H in ``two_view_geometry``), so the
minimal sets are identical.  Inlier masks, inlier counts and the model
choice are equal; poses and points agree to 1e-4 in float32 (LAPACK's
SVD on both sides, the same formulas in another order of a few
operations), and to 1e-9 in float64 where the float32 problem is
ill-conditioned.  Each case also keeps the reference test's own checks
on the port's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.core import se3 as jse3
from gslam_tpu.core.so3 import quat_to_matrix as jquat_to_matrix
from gslam_tpu.core.so3 import so3_exp as jso3_exp
from gslam_tpu.estimation import epipolar as je
from gslam_tpu.estimation import homography as jh
from gslam_tpu.estimation import pnp as jp
from gslam_tpu.estimation.init2view import two_view_geometry as j_two_view
from gslam_tpu_torch.estimation import epipolar as te
from gslam_tpu_torch.estimation import homography as th
from gslam_tpu_torch.estimation import init2view as ti
from gslam_tpu_torch.estimation import pnp as tp
from tests.test_estimation import make_scene
from tests.test_init2view import angle_deg, project_two_views, rot

torch.set_num_threads(2)


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def uniforms(key, B, k):
    return torch.as_tensor(np.asarray(jax.random.uniform(key, (B, k))))


def two_view_uniforms(key, B=256):
    ke, kh = jax.random.split(key)
    return uniforms(ke, B, 8), uniforms(kh, B, 4)


def rot_np(T):
    return np.asarray(jquat_to_matrix(jnp.asarray(np.asarray(T)[3:7])))


def plane_case(seed):
    """tests/test_init2view.py's exact plane: (H, r1, r2, R, t)."""
    rng = np.random.default_rng(seed)
    R = rot(rng.uniform(-0.25, 0.25, 3))
    tt = rng.uniform(-1, 1, 3)
    tt /= np.linalg.norm(tt)
    n = np.array([0.1 * rng.standard_normal(), 0.1 * rng.standard_normal(),
                  -1.0])
    n /= np.linalg.norm(n)
    d, N = 5.0, 120
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-2, 2, N),
                  np.zeros(N)], -1)
    X[:, 2] = (d - X[:, 0] * n[0] - X[:, 1] * n[1]) / n[2]
    if X[:, 2].mean() < 0:
        n = -n
        X[:, 2] = (d - X[:, 0] * n[0] - X[:, 1] * n[1]) / n[2]
    H = (R + np.outer(tt, n) / d).astype(np.float32)
    r1, r2 = project_two_views(X, R, tt, 0.0, rng)
    return H, r1, r2, R, tt


@pytest.mark.parametrize("seed", range(4))
def test_decompose_homography_exact_plane(seed):
    H, r1, r2, R, tt = plane_case(seed)
    N = len(r1)
    T_j, s_j = jh.decompose_homography(jnp.asarray(H), jnp.asarray(r1),
                                       jnp.asarray(r2), jnp.ones(N, bool))
    T_t, s_t = th.decompose_homography(t(H), t(r1), t(r2),
                                       torch.ones(N, dtype=torch.bool))
    assert int(s_t) == int(s_j) == N
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    if angle_deg(rot_np(T_t.numpy()), R) < 1.0:
        assert np.linalg.norm(T_t.numpy()[:3] - tt) < 0.05


def test_decompose_homography_negated_h():
    """H and -H decompose to the same motion in both packages."""
    rng = np.random.default_rng(0)
    R = rot([0.0, 0.13, 0.0])
    tt = np.array([1.0, 0.0, 0.1])
    tt /= np.linalg.norm(tt)
    N = 100
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-2, 2, N),
                  np.full(N, 6.0)], -1)
    H = (R + np.outer(tt, [0.0, 0.0, -1.0]) / 6.0).astype(np.float32)
    r1, r2 = project_two_views(X, R, tt, 0.0, rng)
    out = []
    for Hs in (H, -H):
        T_j, _ = jh.decompose_homography(jnp.asarray(Hs), jnp.asarray(r1),
                                         jnp.asarray(r2), jnp.ones(N, bool))
        T_t, _ = th.decompose_homography(t(Hs), t(r1), t(r2),
                                         torch.ones(N, dtype=torch.bool))
        np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
        out.append(T_t.numpy())
    assert np.allclose(out[0][:3], out[1][:3], atol=1e-3)
    assert min(np.linalg.norm(out[0][3:] - out[1][3:]),
               np.linalg.norm(out[0][3:] + out[1][3:])) < 1e-3


def two_view_case(kind, seed=0):
    """tests/test_init2view.py's TestTwoViewGeometry scenes: (r1, r2,
    sigma, R, t)."""
    rng = np.random.default_rng(seed)
    N = 200
    if kind == "planar":
        X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                      np.zeros(N)], -1)
        X[:, 2] = 8.0 + 0.05 * np.sin(X[:, 0])
        R = rot([0.0, 0.13, 0.0])
        tt = np.array([1.0, 0.0, 0.07])
        tt /= np.linalg.norm(tt)
        r1, r2 = project_two_views(X, R, tt, 3e-4, rng)
        return r1, r2, 5e-3, R, tt
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                  rng.uniform(3, 12, N)], -1)
    R = rot([0.02, -0.15, 0.01])
    tt = np.array([1.0, 0.1, 0.05])
    tt /= np.linalg.norm(tt)
    r1, r2 = project_two_views(X, R, tt, 3e-4 if kind == "general" else 2e-4,
                               rng)
    if kind == "outliers":
        r2[:50] = rng.uniform(-0.5, 0.5, (50, 2)).astype(np.float32)
    return r1, r2, 2e-3, R, tt


def both_two_view(r1, r2, sigma, seed=0, dtype=torch.float32):
    key = jax.random.PRNGKey(seed)
    N = len(r1)
    tv_j = j_two_view(key, jnp.asarray(r1), jnp.asarray(r2),
                      jnp.ones(N, bool), sigma=sigma)
    u_e, u_h = two_view_uniforms(key)
    tv_t = ti.two_view_geometry(t(r1, dtype), t(r2, dtype),
                                torch.ones(N, dtype=torch.bool), sigma=sigma,
                                uniforms=(u_e.to(dtype), u_h.to(dtype)))
    return tv_j, tv_t


@pytest.mark.parametrize("kind", ["general", "planar", "outliers"])
def test_two_view_geometry_matches_reference(kind):
    r1, r2, sigma, R, tt = two_view_case(kind)
    tv_j, tv_t = both_two_view(r1, r2, sigma)
    assert bool(tv_t.used_h) == bool(tv_j.used_h) == (kind == "planar")
    for name in ("n_inliers", "n_e", "n_h"):
        assert int(getattr(tv_t, name)) == int(getattr(tv_j, name)), name
    np.testing.assert_array_equal(tv_t.inliers.numpy(),
                                  np.asarray(tv_j.inliers))
    T = tv_t.T_21.numpy()
    np.testing.assert_allclose(T, np.asarray(tv_j.T_21), atol=1e-4)
    # the reference test's own checks, on the port's result
    if kind == "planar":
        assert angle_deg(rot_np(T), R) < 4.0
        assert np.dot(T[:3] / np.linalg.norm(T[:3]), tt) > 0.85
    elif kind == "general":
        assert angle_deg(rot_np(T), R) < 1.0 and np.dot(T[:3], tt) > 0.95
    else:
        inl = tv_t.inliers.numpy()
        assert inl[50:].mean() > 0.9 and inl[:50].mean() < 0.1


def test_two_view_geometry_from_generator():
    """Without explicit uniforms the port draws E's then H's uniforms
    from its generator (two_view_draws) and recovers the motion."""
    r1, r2, sigma, R, tt = two_view_case("general")
    gen = torch.Generator().manual_seed(3)
    tv = ti.two_view_geometry(t(r1), t(r2), torch.ones(len(r1),
                                                       dtype=torch.bool),
                              sigma=sigma, generator=gen)
    gen2 = torch.Generator().manual_seed(3)
    again = ti.two_view_geometry(t(r1), t(r2),
                                 torch.ones(len(r1), dtype=torch.bool),
                                 sigma=sigma,
                                 uniforms=ti.two_view_draws(256, gen2))
    assert torch.equal(tv.T_21, again.T_21)
    assert not bool(tv.used_h)
    assert angle_deg(rot_np(tv.T_21.numpy()), R) < 1.0
    with pytest.raises(ValueError, match="Generator"):
        ti.two_view_geometry(t(r1), t(r2), torch.ones(len(r1),
                                                      dtype=torch.bool))


def test_find_essential_recovers_pose():
    """tests/test_estimation.py::TestEssential::test_recover_pose."""
    sc = make_scene(np.random.default_rng(0))
    key = jax.random.PRNGKey(0)
    N = len(sc["r1"])
    E_j, inl_j, n_j = je.find_essential(
        key, jnp.asarray(sc["r1"]), jnp.asarray(sc["r2_noisy"]),
        jnp.ones(N, bool), threshold=1e-6)
    E_t, inl_t, n_t = te.find_essential(
        t(sc["r1"]), t(sc["r2_noisy"]), torch.ones(N, dtype=torch.bool),
        threshold=1e-6, uniforms=uniforms(key, 512, 8))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j)
    assert inl_t.numpy()[sc["inlier_gt"]].mean() > 0.9
    assert inl_t.numpy()[~sc["inlier_gt"]].mean() < 0.1
    T_j, s_j = je.decompose_essential(E_j, jnp.asarray(sc["r1"]),
                                      jnp.asarray(sc["r2_noisy"]), inl_j)
    T_t, s_t = te.decompose_essential(E_t, t(sc["r1"]), t(sc["r2_noisy"]),
                                      inl_t)
    assert int(s_t) == int(s_j)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    t_gt = sc["T2"][:3] / np.linalg.norm(sc["T2"][:3])
    assert abs(np.dot(t_gt, T_t.numpy()[:3])) > 0.995


def test_essential_epipolar_constraint():
    sc = make_scene(np.random.default_rng(0), outlier_frac=0.0)
    key = jax.random.PRNGKey(0)
    N = len(sc["r1"])
    E_t, inl_t, _ = te.find_essential(
        t(sc["r1"]), t(sc["r2"]), torch.ones(N, dtype=torch.bool),
        uniforms=uniforms(key, 512, 8))
    _, inl_j, _ = je.find_essential(key, jnp.asarray(sc["r1"]),
                                    jnp.asarray(sc["r2"]), jnp.ones(N, bool))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    pts = np.concatenate([sc["r1"], sc["r2"]], -1)
    d = te.sampson_distance(E_t, t(pts)).numpy()
    assert np.median(d) < 1e-8


def test_essential_from_rt_and_sampson():
    sc = make_scene(np.random.default_rng(0), outlier_frac=0.0)
    T_gt = np.asarray(jse3.se3_mul(jnp.asarray(sc["T2"]),
                                   jse3.se3_inverse(jnp.asarray(sc["T1"]))))
    E_j = je.essential_from_rt(jnp.asarray(T_gt[3:7]), jnp.asarray(T_gt[:3]))
    E_t = te.essential_from_rt(t(T_gt[3:7]), t(T_gt[:3]))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), atol=1e-6)
    pts = np.concatenate([sc["r1"], sc["r2"]], -1)
    d_t = te.sampson_distance(E_t, t(pts)).numpy()
    d_j = np.asarray(je.sampson_distance(E_j, jnp.asarray(pts)))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-3, atol=1e-12)
    assert d_t.max() < 1e-9


def test_find_fundamental_in_pixels():
    sc = make_scene(np.random.default_rng(0))
    key = jax.random.PRNGKey(0)
    N = len(sc["r1"])

    def px(r):
        return (r * 400.0 + np.array([320.0, 240.0])).astype(np.float32)

    _, inl_j, _ = je.find_fundamental(
        key, jnp.asarray(px(sc["r1"])), jnp.asarray(px(sc["r2_noisy"])),
        jnp.ones(N, bool), threshold=2.0)
    _, inl_t, _ = te.find_fundamental(
        t(px(sc["r1"])), t(px(sc["r2_noisy"])),
        torch.ones(N, dtype=torch.bool), threshold=2.0,
        uniforms=uniforms(key, 512, 8))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    inl = inl_t.numpy()
    assert inl[sc["inlier_gt"]].mean() > 0.85
    assert inl[~sc["inlier_gt"]].mean() < 0.15


def test_find_homography_planar():
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    n = 80
    Xp = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                   np.full(n, 5.0)], -1).astype(np.float32)
    T2 = jse3.se3_make(jnp.asarray([0.4, -0.1, 0.2]),
                       jso3_exp(jnp.asarray([0.05, 0.1, -0.03])))
    r1 = Xp[:, :2] / Xp[:, 2:3]
    pc2 = np.asarray(jse3.se3_apply(T2, jnp.asarray(Xp)))
    r2 = pc2[:, :2] / pc2[:, 2:3]
    r2[:20] += 0.1
    H_j, inl_j, _ = jh.find_homography(key, jnp.asarray(r1), jnp.asarray(r2),
                                       jnp.ones(n, bool), threshold=1e-6)
    H_t, inl_t, _ = th.find_homography(t(r1), t(r2),
                                       torch.ones(n, dtype=torch.bool),
                                       threshold=1e-6,
                                       uniforms=uniforms(key, 256, 4))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), atol=1e-4)
    inl = inl_t.numpy()
    assert inl[20:].mean() > 0.9 and inl[:20].mean() < 0.1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_triangulate_roundtrip(dtype):
    sc = make_scene(np.random.default_rng(0), outlier_frac=0.0)
    args = [sc["T1"], sc["T2"], sc["r1"], sc["r2"]]
    if dtype == "float64":
        with jax.enable_x64(True):
            X_j, d_j = je.triangulate(*(jnp.asarray(a.astype(np.float64))
                                        for a in args))
            X_j, d_j = np.asarray(X_j), np.asarray(d_j)
        tol = 1e-9
    else:
        X_j, d_j = je.triangulate(*(jnp.asarray(a) for a in args))
        tol = 1e-4
    X_t, d_t = te.triangulate(*(t(a, getattr(torch, dtype)) for a in args))
    assert X_t.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), atol=tol)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=tol)
    np.testing.assert_allclose(X_t.numpy(), sc["X"], atol=5e-3)
    assert (d_t.numpy() > 0).all()


@pytest.mark.parametrize("noise,dtype", [(0.0, "float64"), (1e-3, "float32"),
                                         (1e-3, "float64")])
def test_dlt_pnp_matches_reference(noise, dtype):
    """The 6-point DLT on 12 points of a volumetric scene: the port's
    pose is the JAX package's.  On exact data the 24 x 12 system's null
    space is ill-conditioned in float32 (the two packages' quaternions
    differ by 0.03 there), so that case is held in float64.  Neither
    package's DLT fixes the sign of P (it flips t alone), so the pose is
    held to the reference's, not to the truth; RANSAC scoring rejects
    such hypotheses."""
    rng = np.random.default_rng(4)
    sc = make_scene(rng, n=12, outlier_frac=0.0)
    rays = sc["r2"] + rng.normal(0, noise, sc["r2"].shape)
    sample = np.concatenate([sc["X"], rays], -1)
    if dtype == "float64":
        with jax.enable_x64(True):
            T_j = np.asarray(jp._dlt_pnp(jnp.asarray(sample.astype(
                np.float64))))
        tol = 1e-9
    else:
        T_j = np.asarray(jp._dlt_pnp(jnp.asarray(sample.astype(np.float32))))
        tol = 1e-4
    T_t = tp._dlt_pnp(t(sample, getattr(torch, dtype))).numpy()
    assert T_t.dtype == getattr(np, dtype)
    # q and -q are one rotation
    sign = np.sign(np.dot(T_t[3:], T_j[3:]))
    np.testing.assert_allclose(T_t[:3], T_j[:3], atol=tol)
    np.testing.assert_allclose(T_t[3:], sign * T_j[3:], atol=tol)


def test_dlt_pnp_batched():
    """Leading batch dimensions, as RANSAC's minimal solvers get them."""
    rng = np.random.default_rng(5)
    samples = []
    for _ in range(3):
        sc = make_scene(rng, n=8, outlier_frac=0.0)
        samples.append(np.concatenate([sc["X"], sc["r2"]], -1))
    samples = np.stack(samples)
    T_b = tp._dlt_pnp(t(samples))
    for i in range(3):
        np.testing.assert_allclose(T_b[i].numpy(),
                                   tp._dlt_pnp(t(samples[i])).numpy(),
                                   atol=1e-6)
