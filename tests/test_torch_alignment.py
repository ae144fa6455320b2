"""The RANSAC alignment fits and the point cull (the last helpers of
ROADMAP item 18) against the JAX package's: ``find_sim3``,
``find_affine3d`` and ``find_plane`` on tests/test_estimation.py:201-237's
inputs with the reference's RANSAC draws replayed
(``jax.random.uniform(key, (B, k))``), and ``cull_points`` on
tests/test_map.py:199-211's arena.

Tolerances: inlier masks and counts exactly; the Sim3 to 1e-5, the
affine map to 1e-5 (a 4x4 least-squares solve by two libraries; measured
6e-7), the plane exactly (both pick the same minimal set); the culled
arena bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.core.sim3 import sim3_apply, sim3_make
from gslam_tpu.core.so3 import so3_exp
from gslam_tpu.estimation import alignment as jal
from gslam_tpu.map import arena as ja
from gslam_tpu_torch import convert
from gslam_tpu_torch.estimation import alignment as tal
from gslam_tpu_torch.map import arena as ta
from tests.test_torch_arena import assert_same, jfields

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)


def draws(B, k, key=KEY):
    """The reference's RANSAC uniforms for ``key``."""
    return torch.tensor(np.asarray(jax.random.uniform(key, (B, k))))


def sim3_case(rng, scale=1.3):
    src = rng.normal(size=(60, 3)).astype(np.float32)
    S_gt = sim3_make(jnp.asarray([0.3, 0.1, -0.2]),
                     so3_exp(jnp.asarray([0.1, 0.2, -0.05])),
                     jnp.asarray([scale]))
    dst = np.array(sim3_apply(S_gt, jnp.asarray(src)))
    dst[:15] += rng.uniform(0.5, 1.0, (15, 3))
    return src, dst


@pytest.mark.parametrize("with_scale", [True, False])
def test_find_sim3_matches_reference(with_scale):
    """tests/test_estimation.py:201's case; without scale on an SE3 (a
    scale of 1), since an SE3 fit of the scaled case has no inliers."""
    src, dst = sim3_case(np.random.default_rng(0),
                         1.3 if with_scale else 1.0)
    valid = np.ones(60, bool)
    valid[20] = False
    S_j, inl_j, n_j = jal.find_sim3(KEY, jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(valid), threshold=0.01,
                                    with_scale=with_scale)
    S_t, inl_t, n_t = tal.find_sim3(
        torch.tensor(src), torch.tensor(dst), torch.tensor(valid),
        threshold=0.01, with_scale=with_scale, uniforms=draws(256, 3))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=1e-5)
    assert inl_t[15:].sum() == 44 and not inl_t[:15].any()
    assert abs(float(S_t[7]) - (1.3 if with_scale else 1.0)) < 0.01


def test_find_sim3_with_a_generator():
    src, dst = sim3_case(np.random.default_rng(0))
    S, inl, n = tal.find_sim3(torch.tensor(src), torch.tensor(dst),
                              torch.ones(60, dtype=torch.bool),
                              generator=torch.Generator().manual_seed(1))
    assert inl[15:].all() and not inl[:15].any() and int(n) == 45
    assert abs(float(S[7]) - 1.3) < 0.01


def test_find_affine3d_matches_reference():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(40, 3)).astype(np.float32)
    M_gt = np.array([[1.1, 0.1, 0, 0.5], [0, 0.9, -0.1, -1.0],
                     [0.05, 0, 1.2, 2.0]], np.float32)
    dst = src @ M_gt[:, :3].T + M_gt[:, 3]
    dst[:5] += 1.0
    M_j, inl_j, n_j = jal.find_affine3d(KEY, jnp.asarray(src),
                                        jnp.asarray(dst), jnp.ones(40, bool))
    M_t, inl_t, n_t = tal.find_affine3d(
        torch.tensor(src), torch.tensor(dst), torch.ones(40, dtype=torch.bool),
        uniforms=draws(256, 4))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) == 35
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), atol=1e-5)
    np.testing.assert_allclose(M_t.numpy(), M_gt, atol=1e-3)


def plane_case(rng, n_pl=70):
    pts = np.zeros((100, 3), np.float32)
    pts[:n_pl, 0] = rng.uniform(-2, 2, n_pl)
    pts[:n_pl, 1] = rng.uniform(-2, 2, n_pl)
    pts[:n_pl, 2] = 0.5 * pts[:n_pl, 0] - 0.25 * pts[:n_pl, 1] + 2.0
    pts[n_pl:] = rng.uniform(-3, 3, (30, 3)).astype(np.float32)
    return pts


@pytest.mark.parametrize("seed,B", [(0, 128), (3, 16)])
def test_find_plane_matches_reference(seed, B):
    """Both packages, the same draws, the same plane.  With the test's
    128 draws a minimal set that repeats a point wins in both (its zero
    plane scores every point: a quirk of the reference, kept); 16 draws
    of key 3 hold no repeat and find the true plane."""
    pts = plane_case(np.random.default_rng(0))
    key = jax.random.PRNGKey(seed)
    pl_j, inl_j, n_j = jal.find_plane(key, jnp.asarray(pts),
                                      jnp.ones(100, bool), threshold=0.01,
                                      B=B)
    pl_t, inl_t, n_t = tal.find_plane(
        torch.tensor(pts), torch.ones(100, dtype=torch.bool), threshold=0.01,
        B=B, uniforms=draws(B, 3, key))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j)
    np.testing.assert_array_equal(pl_t.numpy(), np.asarray(pl_j))
    assert inl_t[:70].float().mean() > 0.95


def cull_case():
    """tests/test_map.py's TestEraseAndCovis arena: 3 frames, 6 points,
    points 0-3 seen by frames 0 and 1, points 4-5 by frames 1 and 2."""
    from tests.test_map import TestEraseAndCovis

    a = TestEraseAndCovis().build()
    return a.replace(n_frames=jnp.asarray(10, jnp.int32))


@pytest.mark.parametrize("min_obs,min_age,kept", [(2, 0, 6), (3, 0, 0),
                                                  (3, 20, 6)])
def test_cull_points_matches_reference(min_obs, min_age, kept):
    a = cull_case()
    t = convert.arena_from_numpy(jfields(a), device="cpu")
    out_j = ja.cull_points(a, min_obs=min_obs, min_age_frames=min_age)
    out_t = ta.cull_points(t, min_obs=min_obs, min_age_frames=min_age)
    assert_same(out_j, out_t)
    assert ta.arena_stats(out_t)["valid_points"] == kept
