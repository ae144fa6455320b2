"""The port's lens models (gslam_tpu_torch.core.camera) against the JAX
package's (gslam_tpu/core/camera.py): pinhole, ATAN, OpenCV and OCAM with
the calibrations of tests/test_geometry.py.

Tolerances: unprojected rays to 1e-6 absolute (z = 1 rays, unit rays for
OCAM); projected pixels to 1e-4 px or 2 float32 ulps of the coordinate,
whichever is larger (the transcendental functions of XLA's CPU backend
and of PyTorch differ by an ulp: ATAN's tan / atan, OCAM's atan2, which
at u ~ 600 px is 6.1e-5 px an ulp); validity masks, parameter vectors,
K() and from_fov equal; the OpenCV undistortion to the same bits as the
reference's at its fixed 8 iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LENS_ARGS, ocam_calibration
from gslam_tpu.core import camera as jc
from gslam_tpu_torch.core import camera as tc
from tests.test_torch_batch import HostReads

torch.set_num_threads(2)


# tests/test_geometry.py:185-246's calibrations (VGA; OCAM its
# near-equidistant fit), shared with chip_smoke.py's lens phase
CAMERAS = LENS_ARGS


def pair(model):
    args = CAMERAS[model]
    return getattr(jc.Camera, model)(*args), getattr(tc.Camera, model)(*args)


def points(seed=0, n=2000):
    """Seeded camera-frame points: a wide cone, some behind the camera
    and some on the optical axis."""
    rng = np.random.default_rng(seed)
    p = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                        rng.uniform(0.3, 4.0, (n, 1))], -1)
    p[:, :2] *= p[:, 2:]
    p[:40, 2] *= -1.0
    p[40:45, :2] = 0.0
    return p.astype(np.float32)


def pixel_grid(W=640, H=480, step=1):
    uu, vv = np.meshgrid(np.arange(0, W, step) + 0.5,
                         np.arange(0, H, step) + 0.5)
    return np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)


def assert_pixels_close(got, ref):
    tol = np.maximum(1e-4, 2 * np.spacing(np.abs(ref).astype(np.float32)))
    err = np.abs(got - ref)
    ok = (err <= tol) | (~np.isfinite(ref) & ~np.isfinite(got))
    assert ok.all(), (err[~ok].max(), ref[~ok][:4])


@pytest.mark.parametrize("model", list(CAMERAS))
def test_project_against_reference(model):
    cj, ct = pair(model)
    np.testing.assert_array_equal(ct.params, cj.params)
    p = points()
    uv_j, ok_j = cj.project(jnp.asarray(p))
    uv_t, ok_t = ct.project(torch.from_numpy(p))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.sum() > 500
    assert_pixels_close(uv_t.numpy(), np.asarray(uv_j))


@pytest.mark.parametrize("model", list(CAMERAS))
def test_unproject_against_reference(model):
    cj, ct = pair(model)
    uv = pixel_grid()
    rj = np.asarray(cj.unproject(jnp.asarray(uv)))
    rt = ct.unproject(torch.from_numpy(uv)).numpy()
    assert rt.shape == (640 * 480, 3) and np.isfinite(rt).all()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-6)
    if model == "ocam":
        np.testing.assert_allclose(np.linalg.norm(rt, axis=-1), 1.0,
                                   atol=1e-6)
    else:
        assert (rt[:, 2] == 1.0).all()


@pytest.mark.parametrize("model", list(CAMERAS))
def test_round_trip(model):
    """project -> unproject returns the ray (tests/test_geometry.py's
    round trips, on the port)."""
    _, ct = pair(model)
    rng = np.random.default_rng(1)
    xy = rng.uniform(-0.4, 0.4, (300, 2))
    p = np.concatenate([xy, np.ones((300, 1))], -1).astype(np.float32)
    uv, valid = ct.project(torch.from_numpy(p))
    ray = ct.unproject(uv).numpy()
    assert valid.all()
    if model == "ocam":
        cos = np.abs((ray * p).sum(-1)) / np.linalg.norm(p, axis=-1)
        assert (cos > 0.999).all()
    else:
        np.testing.assert_allclose(ray / ray[:, 2:3], p, atol=1e-3)


def test_opencv_undistortion_runs_exactly_eight_fixed_point_steps():
    cj, ct = pair("opencv")
    uv = pixel_grid(step=7)
    pj = jnp.asarray(cj.params)
    pt = torch.from_numpy(ct.params)
    for iters in (1, 3, 8):
        np.testing.assert_array_equal(
            tc.opencv_unproject(pt, torch.from_numpy(uv), iters).numpy(),
            np.asarray(jc.opencv_unproject(pj, jnp.asarray(uv), iters)))
    # the default is 8 steps, no convergence test: the same bits as an
    # explicit 8-step loop, other bits than 7 or 9 steps at the corners
    got = ct.unproject(torch.from_numpy(uv)).numpy()
    np.testing.assert_array_equal(
        got, tc.opencv_unproject(pt, torch.from_numpy(uv), 8).numpy())
    for other in (7, 9):
        assert not np.array_equal(
            got, tc.opencv_unproject(pt, torch.from_numpy(uv), other).numpy())


def test_atan_without_distortion_is_the_pinhole():
    args = CAMERAS["pinhole"]
    at = tc.Camera.atan(*args, 0.0)
    ph = tc.Camera.pinhole(*args)
    p = torch.from_numpy(points(2))
    uv_a, ok_a = at.project(p)
    uv_p, ok_p = ph.project(p)
    assert torch.isfinite(uv_a).all() and torch.equal(ok_a, ok_p)
    torch.testing.assert_close(uv_a, uv_p, rtol=0, atol=1e-4)
    uv = torch.from_numpy(pixel_grid(step=9))
    r = at.unproject(uv)
    assert torch.isfinite(r).all()
    torch.testing.assert_close(r, ph.unproject(uv), rtol=0, atol=1e-6)


def test_descriptor_helpers():
    for model in CAMERAS:
        cj, ct = pair(model)
        np.testing.assert_array_equal(ct.K(), cj.K())
        assert ct.K().dtype == np.float32
        assert ct.info() == cj.info()
        assert ct.is_valid() and cj.is_valid()
        assert (ct.fx, ct.fy, ct.cx, ct.cy) == (cj.fx, cj.fy, cj.cx, cj.cy)
    # OCAM's "fx" reads params[0], the centre's x (the reference's quirk)
    assert pair("ocam")[1].fx == 320.0
    assert len(pair("ocam")[1].params) == 5 + tc.OCAM_POLY_N \
        + tc.OCAM_INVPOLY_N
    np.testing.assert_array_equal(tc.ocam_pack(*ocam_calibration()),
                                  jc.ocam_pack(*ocam_calibration()))
    for fov in (50.0, 70.0, 100.0):
        np.testing.assert_array_equal(
            tc.Camera.from_fov(752, 480, fov).params,
            jc.Camera.from_fov(752, 480, fov).params)
    assert not tc.Camera.pinhole(0, 480, 1, 1, 1, 1).is_valid()
    with pytest.raises(ValueError, match="unknown camera model"):
        tc.Camera("fisheye", 64, 48, [1, 1, 1, 1])


def test_polyval_is_horner_from_the_padded_top():
    c = torch.tensor([0.5, -1e-3, 2e-6, 0.0, 0.0], dtype=torch.float32)
    x = torch.linspace(0, 300, 101)
    acc = torch.zeros_like(x)
    for i in (4, 3, 2, 1, 0):
        acc = acc * x + c[i]
    assert torch.equal(tc._polyval(c, x), acc)
    np.testing.assert_array_equal(
        tc._polyval(c, x).numpy(),
        np.asarray(jc._polyval(jnp.asarray(c.numpy()),
                               jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("model", list(CAMERAS))
def test_models_read_nothing_back(model):
    """project / unproject run inside a captured CUDA graph: no host
    read and no host constant copied in (params are resident first)."""
    _, ct = pair(model)
    ct.params_on("cpu")
    p = torch.from_numpy(points(3, 64))
    uv = torch.from_numpy(pixel_grid(step=40))
    with HostReads() as guard:
        ct.project(p)
        ct.unproject(uv)
    assert guard.found == []
