"""The port's pyramid extraction (gslam_tpu_torch.ops.frontend.
image_pyramid / extract_features_pyramid) and KeyframeSLAM with
``n_levels`` > 1, against the JAX package's.

* ``image_pyramid``: the levels' shapes equal and their pixels within
  2e-6 of ``jax.image.resize(..., "linear")`` (both antialias when they
  shrink; the filters' sums run in another order).
* ``extract_features_pyramid`` fed the JAX package's level images: the
  level budgets, uv, scores, validity and count bit for bit; BRIEF bit
  for bit on the textured VGA frame, and on the untextured 192x144 frame
  99% of bits (the blur's and orientation moments' FMA contraction in
  XLA's CPU backend, tests/test_torch_frontend.py: on exactly flat
  regions rounding decides BRIEF pairs).
* The whole pyramid from each package's own resize: the share of equal
  keypoints is 100% on the VGA frame and at least 99% on the 192x144
  frame (a level pixel that moves by an ulp can flip a FAST decision at
  the threshold).
* The cases of tests/test_frontend.py:209-255 on the port.
* A 12-frame ``n_levels=3`` run at 192x144 meets the reference's gate
  (ATE < 0.08 m, tests/test_slam_e2e.py:319-326) and lies within 0.01 m
  of the JAX package's own ATE on the same frames.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gslam_tpu.datasets.synthetic import SyntheticDataset as JData
from gslam_tpu.eval import evaluate_trajectory as j_eval
from gslam_tpu.models.keyframe_slam import KeyframeSLAM as JSLAM
from gslam_tpu.models.keyframe_slam import SLAMConfig as JConfig
from gslam_tpu.ops import frontend as jf
from gslam_tpu_torch.eval.trajectory import evaluate_trajectory
from gslam_tpu_torch.models.keyframe_slam import KeyframeSLAM, SLAMConfig
from gslam_tpu_torch.ops import frontend as tf
from gslam_tpu_torch.ops.cuda import brief, fastnms
from gslam_tpu_torch.ops.matching import match_descriptors
from test_frontend import blob_image
from tests.test_torch_slam import CFG, datasets, run

torch.set_num_threads(2)

# a frame of tests/test_slam_e2e.py's sequence and one of chip_smoke.py's
FRAMES = {
    "small": (dict(n_frames=1, n_points=300, width=192, height=144,
                   motion="line", depth=True), 192, 0.1, 0.99),
    "vga": (dict(n_frames=1, n_points=1200, width=640, height=480,
                 motion="ring_out", depth=True, texture=True, radius=14.0,
                 world_extent=8.0, noise=0.01), 512, 0.08, 1.0),
}


@functools.cache
def frame_image(name):
    ds = JData(**FRAMES[name][0])
    ds.open("synth://")
    return ds.grab_frame().image


@pytest.mark.parametrize("name", sorted(FRAMES))
@pytest.mark.parametrize("scale,n_levels", [(1.25, 3), (2.0, 3), (1.5, 4)])
def test_image_pyramid_matches_reference(name, scale, n_levels):
    img = frame_image(name)
    pj = jf.image_pyramid(jnp.asarray(img), n_levels=n_levels, scale=scale)
    pt = tf.image_pyramid(torch.from_numpy(img), n_levels=n_levels,
                          scale=scale)
    assert len(pt) == len(pj) == n_levels
    assert torch.equal(pt[0], torch.from_numpy(img))
    for a, b in zip(pj, pt):
        assert tuple(b.shape) == a.shape and b.is_contiguous()
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-6)


def test_pyramid_budgets_match_reference():
    for shape, mk, n, s in [((480, 640), 512, 3, 1.25), ((144, 192), 192, 3,
                                                          1.25),
                            ((160, 224), 256, 3, 1.5), ((100, 160), 64, 5,
                                                        2.0)]:
        pyr = jf.image_pyramid(jnp.zeros(shape), n_levels=n, scale=s)
        areas = np.asarray([p.shape[0] * p.shape[1] for p in pyr],
                           np.float64)
        ks = np.maximum(8, np.round(mk * areas / areas.sum()).astype(int))
        ks[0] += mk - int(ks.sum())
        got = tf.pyramid_budgets([p.shape for p in pyr], mk)
        np.testing.assert_array_equal(got, ks)
        assert got.sum() == mk and (got >= 8).all()


def bits_same(d_j, d_t):
    a = np.unpackbits(np.asarray(d_j).view(np.uint8))
    b = np.unpackbits(d_t.numpy().view(np.uint32).view(np.uint8))
    return (a == b).mean()


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_extraction_on_the_reference_levels(name, monkeypatch):
    """The port's extract_features_pyramid with image_pyramid replaced by
    the JAX package's levels: everything but BRIEF bit for bit."""
    _, mk, thr, min_bits = FRAMES[name]
    img = frame_image(name)
    fj = jf.extract_features_pyramid(jnp.asarray(img), max_kps=mk,
                                     threshold=thr, n_levels=3, scale=1.25)
    levels = [torch.from_numpy(np.array(a)) for a in
              jf.image_pyramid(jnp.asarray(img), n_levels=3, scale=1.25)]
    monkeypatch.setattr(tf, "image_pyramid", lambda *a, **k: levels)
    ft = tf.extract_features_pyramid(torch.from_numpy(img), max_kps=mk,
                                     threshold=thr, n_levels=3, scale=1.25,
                                     use_kernels=False)
    assert ft.uv.shape == (mk, 2) and ft.count.dtype == torch.int32
    assert int(ft.count) == int(fj.count) > 30
    for k in ("uv", "score", "valid"):
        np.testing.assert_array_equal(getattr(ft, k).numpy(),
                                      np.asarray(getattr(fj, k)), k)
    if min_bits == 1.0:
        np.testing.assert_array_equal(ft.desc.numpy().view(np.uint32),
                                      np.asarray(fj.desc))
    assert bits_same(fj.desc, ft.desc) >= min_bits


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_pyramid_from_own_resize(name):
    """Each package resizes on its own: the share of keypoints (level-0
    uv, to 1e-3 px) both find is 100% on the textured VGA frame and at
    least 99% on the untextured one."""
    _, mk, thr, min_share = FRAMES[name]
    img = frame_image(name)
    fj = jf.extract_features_pyramid(jnp.asarray(img), max_kps=mk,
                                     threshold=thr, n_levels=3, scale=1.25)
    ft = tf.extract_features_pyramid(torch.from_numpy(img), max_kps=mk,
                                     threshold=thr, n_levels=3, scale=1.25,
                                     use_kernels=False)
    a = {tuple(p) for p in np.round(np.asarray(fj.uv)[np.asarray(fj.valid)],
                                    3)}
    b = {tuple(p) for p in np.round(ft.uv.numpy()[ft.valid.numpy()], 3)}
    share = len(a & b) / len(a)
    assert share >= min_share, share
    assert abs(int(ft.count) - int(fj.count)) <= (1 - min_share) * mk


def test_kernel_route_takes_plain_versions_on_cpu():
    """use_kernels on CPU tensors: B1 and B2 wrappers take their plain
    versions (no launch counted), with the plain route's result."""
    img = torch.from_numpy(frame_image("small"))
    before = (fastnms.launches, brief.launches)
    fk = tf.extract_features_pyramid(img, max_kps=192, threshold=0.1,
                                     n_levels=3, use_kernels=True)
    fp = tf.extract_features_pyramid(img, max_kps=192, threshold=0.1,
                                     n_levels=3, use_kernels=False)
    assert (fastnms.launches, brief.launches) == before
    for a, b in zip(fk, fp):
        assert torch.equal(a, b)


# the port's cases of tests/test_frontend.py:209-255

def test_pyramid_shapes():
    pyr = tf.image_pyramid(torch.zeros((100, 160)), n_levels=3, scale=2.0)
    assert [tuple(p.shape) for p in pyr] == [(100, 160), (50, 80),
                                             (25, 40)]


def test_blur_preserves_mean():
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 1, (64, 64)).astype(np.float32))
    out = tf.gaussian_blur(img)
    assert abs(float(out[20:44, 20:44].mean())
               - float(img[20:44, 20:44].mean())) < 0.02


def test_multiscale_finds_scaled_features():
    img = torch.from_numpy(blob_image(np.random.default_rng(0), H=160,
                                      W=224, n=35))
    f = tf.extract_features_pyramid(img, max_kps=256, threshold=0.08,
                                    n_levels=3, scale=1.5,
                                    use_kernels=False)
    assert f.uv.shape == (256, 2)
    assert int(f.count) > 30
    uv = f.uv.numpy()[f.valid.numpy()]
    assert (uv[:, 0] < 224).all() and (uv[:, 1] < 160).all()


def test_scale_invariant_matching():
    """A 1.5x-zoomed view still matches through pyramid descriptors."""
    img = torch.from_numpy(blob_image(np.random.default_rng(0), H=160,
                                      W=224, n=35))
    zoom = F.interpolate(img[None, None], size=(240, 336), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]
    crop = zoom[40:200, 56:280].contiguous()
    kw = dict(max_kps=256, threshold=0.08, n_levels=3, scale=1.5,
              use_kernels=False)
    f1 = tf.extract_features_pyramid(img, **kw)
    f2 = tf.extract_features_pyramid(crop, **kw)
    m = match_descriptors(f1.desc, f1.valid, f2.desc, f2.valid, ratio=0.9)
    assert int(m.count) >= 8


def test_keyframe_slam_with_pyramid():
    cfg = dict(CFG, n_levels=3)
    dj, dt = datasets()
    js = JSLAM(dj.camera, JConfig(**cfg))
    t, gt = run(js, dj)
    ate_j = j_eval(t, js.positions(), t, gt, with_scale=False).ate_rmse
    ts = KeyframeSLAM(dt.camera, SLAMConfig(**cfg), device="cpu")
    t, gt = run(ts, dt)
    m = evaluate_trajectory(t, ts.positions(), t, gt, with_scale=False)
    assert m.n_matched == len(t)
    assert m.ate_rmse < 0.08
    assert abs(m.ate_rmse - ate_j) <= 0.01
    assert ts.stats[0]["n_features"] > 100
    assert min(s["n_inliers"] for s in ts.stats[1:]) >= 20
