"""The port's undistortion and stereo rectification
(gslam_tpu_torch.core.undistort) against the JAX package's
(gslam_tpu/core/undistort.py).

Tolerances: remap tables (source pixel coordinates) to 1e-4 px or 2
float32 ulps of the coordinate (the lens models' tolerance,
test_torch_camera.py), validity masks equal but where a coordinate lies
within that tolerance of the image border; R_rect and the baseline to
1e-12 (the same float64 numpy arithmetic); remapped images to 1e-6 on
values in [0, 1] (XLA fuses the reference's jitted bilinear blend, which
may round differently from the port's separate operations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.core import undistort as ju
from gslam_tpu.core.camera import Camera as JCamera
from gslam_tpu.datasets.synthetic import SyntheticDataset as JData
from gslam_tpu_torch.core import undistort as tu
from gslam_tpu_torch.core.camera import Camera
from tests.test_torch_camera import CAMERAS, assert_pixels_close

torch.set_num_threads(2)

# the TUM benchmark's Freiburg-1 calibration (gslam_tpu/datasets/tum_rgbd.py)
FR1 = (640, 480, 517.3, 516.5, 318.6, 255.3,
       0.2624, -0.9531, -0.0054, 0.0026, 1.1633)


def assert_masks_equal(got, ref, uv):
    """Equal validity, but where a pixel coordinate lies within the
    tolerance of the image's border (0 or W, H)."""
    differ = got != ref
    if differ.any():
        W, H = ref.shape[1], ref.shape[0]
        near = ((np.abs(uv[..., 0]) < 2e-4) | (np.abs(uv[..., 0] - W) < 2e-4)
                | (np.abs(uv[..., 1]) < 2e-4)
                | (np.abs(uv[..., 1] - H) < 2e-4))
        assert near[differ].all(), np.argwhere(differ & ~near)[:4]


@pytest.mark.parametrize("model", ["fr1", "atan", "opencv", "ocam"])
def test_undistorter_maps(model):
    if model == "fr1":
        cj, ct = JCamera.opencv(*FR1), Camera.opencv(*FR1)
    else:
        cj = getattr(JCamera, model)(*CAMERAS[model])
        ct = getattr(Camera, model)(*CAMERAS[model])
    uj, ut = ju.Undistorter(cj), tu.Undistorter(ct)
    assert ut.map_xy.shape == (480, 640, 2) and ut.map_xy.dtype == np.float32
    np.testing.assert_array_equal(ut.cam_out.params, uj.cam_out.params)
    assert_pixels_close(ut.map_xy, uj.map_xy)
    assert_masks_equal(ut.valid, uj.valid, uj.map_xy)
    assert 0.3 < ut.valid.mean() <= 1.0


def textured(seed=0, H=480, W=640):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = (0.5 + 0.25 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
           + rng.uniform(-0.2, 0.2, (H, W)))
    return img.clip(0, 1).astype(np.float32)


def test_remap_on_a_textured_image():
    uj = ju.Undistorter(JCamera.opencv(*FR1))
    ut = tu.Undistorter(Camera.opencv(*FR1))
    img = textured()
    got = ut.undistort(torch.from_numpy(img)).numpy()
    ref = np.asarray(uj.undistort(jnp.asarray(img)))
    assert got.dtype == np.float32 and got.shape == (480, 640)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got[~ut.valid] == 0).all() and got[ut.valid].std() > 0.05
    # the gather itself, on the same table and mask in both packages,
    # including coordinates outside the image (clipped)
    rng = np.random.default_rng(4)
    m = rng.uniform(-5, 650, (300, 2)).astype(np.float32)
    v = rng.random(300) > 0.2
    np.testing.assert_allclose(
        tu._remap(torch.from_numpy(img), torch.from_numpy(m),
                  torch.from_numpy(v)).numpy(),
        np.asarray(ju._remap(jnp.asarray(img), jnp.asarray(m),
                             jnp.asarray(v))), rtol=0, atol=1e-6)


def rot(axis, deg):
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    m = {"x": [[1, 0, 0], [0, c, -s], [0, s, c]],
         "y": [[c, 0, s], [0, 1, 0], [-s, 0, c]],
         "z": [[c, -s, 0], [s, c, 0], [0, 0, 1]]}
    return np.array(m[axis])


def rotated_rig():
    """tests/test_datasets_eval.py:350's rig: the distorted 320x240
    synthetic camera, cam1 turned 2 / 1 / 0.5 degrees about y / x / z and
    1.2 m along x."""
    R10 = rot("y", 2.0) @ rot("x", 1.0) @ rot("z", 0.5)
    c1 = np.array([1.2, 0.0, 0.0])
    T10 = np.eye(4)
    T10[:3, :3] = R10
    T10[:3, 3] = -R10 @ c1
    return R10, c1, T10


def test_stereo_rectifier_against_reference():
    ds = JData(n_frames=2, n_points=0, width=320, height=240, motion="line",
               texture=True, depth=False, distortion=[-0.25, 0.08],
               world_extent=6.0)
    ds.open("synth://")
    cj = ds.camera
    ct = Camera(cj.model, cj.width, cj.height, cj.params)
    R10, c1, T10 = rotated_rig()
    rj = ju.StereoRectifier(cj, cj, T10)
    rt = tu.StereoRectifier(ct, ct, T10)
    assert abs(rt.baseline - 1.2) < 1e-9
    np.testing.assert_allclose(rt.baseline, rj.baseline, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rt.R_rect, rj.R_rect, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(rt.camera.params, rj.camera.params)
    for (mt, vt), (mj, vj) in zip(rt.maps, rj.maps):
        assert_pixels_close(mt, mj)
        assert_masks_equal(vt, vj, mj)
    img0, _ = ds._render(np.eye(3), np.zeros(3), False)
    img1, _ = ds._render(R10.T, c1, False)
    got = rt.rectify(torch.from_numpy(img0), torch.from_numpy(img1))
    ref = rj.rectify(jnp.asarray(img0), jnp.asarray(img1))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
