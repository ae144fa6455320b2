"""Gold tests of the port's geometry (gslam_tpu_torch.core) against
gslam_tpu.core: the same numpy inputs through both, allclose at 1e-5
(float32 on both sides; the formulas are the same, only the order of a
few float32 operations may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.core import camera as jcam
from gslam_tpu.core import se3 as jse3
from gslam_tpu.core import so3 as jso3
from gslam_tpu_torch.core import camera as tcam
from gslam_tpu_torch.core import se3 as tse3
from gslam_tpu_torch.core import so3 as tso3

torch.set_num_threads(2)
ATOL = 1e-5


def rand_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def rand_poses(rng, n):
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([t, rand_quats(rng, n)], -1)


def both(jfn, tfn, *args):
    j = np.asarray(jfn(*[jnp.asarray(a) for a in args]))
    t = tfn(*[torch.tensor(a) for a in args]).numpy()
    return j, t


@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate", "so3_exp",
                                  "so3_log", "quat_to_matrix",
                                  "matrix_to_quat"])
def test_so3_matches_reference(rng, name):
    q1, q2 = rand_quats(rng, 64), rand_quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    phi = rng.normal(size=(64, 3)).astype(np.float32)
    phi[:4] *= np.float32(1e-6)                   # small-angle branches
    args = {
        "quat_mul": (q1, q2),
        "quat_rotate": (q1, v),
        "so3_exp": (phi,),
        "so3_log": (q1,),
        "quat_to_matrix": (q1,),
        "matrix_to_quat": (np.asarray(jso3.quat_to_matrix(jnp.asarray(q1))),),
    }[name]
    j, t = both(getattr(jso3, name), getattr(tso3, name), *args)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("name", ["se3_mul", "se3_inverse", "se3_apply",
                                  "se3_exp", "se3_log"])
def test_se3_matches_reference(rng, name):
    A, B = rand_poses(rng, 64), rand_poses(rng, 64)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    xi[:4, 3:] *= np.float32(1e-6)
    args = {
        "se3_mul": (A, B),
        "se3_inverse": (A,),
        "se3_apply": (A, x),
        "se3_exp": (xi,),
        "se3_log": (A,),
    }[name]
    j, t = both(getattr(jse3, name), getattr(tse3, name), *args)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_pinhole_matches_reference(rng):
    cam = np.asarray([400.0, 410.0, 160.0, 120.0], np.float32)
    p = rng.normal(size=(100, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2]) + 0.5
    p[:5, 2] = -1.0                               # behind the camera
    uv_j, ok_j = jcam.pinhole_project(jnp.asarray(cam), jnp.asarray(p))
    uv_t, ok_t = tcam.pinhole_project(torch.as_tensor(cam), torch.as_tensor(p))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6,
                               atol=ATOL)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    uv = rng.uniform(0, 320, size=(100, 2)).astype(np.float32)
    j, t = both(jcam.pinhole_unproject, tcam.pinhole_unproject, cam, uv)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("scale", ["tiny", "small_angle", "small_sigma",
                                   "large"])
def test_sim3_exp_log_match_reference(scale):
    """sim3_exp / sim3_log against the JAX package to 1e-5, through every
    Taylor branch of W (tiny angle, tiny log-scale, both, neither), and
    the round trip."""
    from gslam_tpu.core import sim3 as jsim3
    from gslam_tpu_torch.core import sim3 as tsim3

    rng = np.random.default_rng(len(scale))
    xi = rng.normal(0, 1.0, (64, 7)).astype(np.float32)
    xi[:, 3:6] *= 0.5                       # angles below pi
    xi[:, 6] *= 0.7                         # scales e^-2 .. e^2
    if scale in ("tiny", "small_angle"):
        xi[:, 3:6] *= 1e-6
    if scale in ("tiny", "small_sigma"):
        xi[:, 6] *= 1e-7
    S_j = np.asarray(jsim3.sim3_exp(jnp.asarray(xi)))
    S_t = tsim3.sim3_exp(torch.tensor(xi))
    np.testing.assert_allclose(S_t.numpy(), S_j, atol=1e-5)
    np.testing.assert_allclose(
        tsim3._sim3_W(torch.tensor(xi[:, 3:6]),
                      torch.tensor(xi[:, 6:7])).numpy(),
        np.asarray(jsim3._sim3_W(jnp.asarray(xi[:, 3:6]),
                                 jnp.asarray(xi[:, 6:7]))), atol=1e-5)
    back_j = np.asarray(jsim3.sim3_log(jnp.asarray(S_j)))
    back_t = tsim3.sim3_log(torch.tensor(S_j)).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=1e-5)
    np.testing.assert_allclose(back_t, xi, atol=2e-5)
    # a zero scale: W is singular; non-finite, not an exception
    bad = torch.tensor([[1.0, 2.0, 3.0, 1.0, 0.0, 0.0, 0.0, 0.0]])
    assert tsim3.sim3_log(bad).shape == (1, 7)
