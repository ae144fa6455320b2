"""Gold tests of the port's frontend (gslam_tpu_torch.ops.frontend)
against gslam_tpu.ops.frontend on the jnp path (use_pallas=False, the
path the Pallas kernels are held to in test_pallas.py).  The same numpy
images go through both packages.

Tolerances: blur, FAST score and NMS to 1e-5 (float32, the same
shift-and-add and arc-sum order on both sides); keypoint indices,
validity and count exactly; BRIEF bit for bit given the same uv and
angle.  End to end, 99.9% of descriptor bits must agree on textured
images: XLA's CPU backend contracts the blur's and the orientation
moments' multiply-adds into FMAs, which the port does not, so blurred
pixels and angles differ by an ulp; an angle that moves by an ulp can
move a rotated sample point that lies within rounding of a pixel
boundary.  On an image with exactly flat regions ("blobs") many BRIEF
pairs compare two samples of the flat background, equal in exact
arithmetic, and rounding decides them: there 99% must agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.map.arena import DESC_WORDS as J_DESC_WORDS
from gslam_tpu.models.graft import example_inputs as j_example_inputs
from gslam_tpu.ops import frontend as jf
from gslam_tpu_torch.models.graft import example_image
from gslam_tpu_torch.ops import frontend as tf
from gslam_tpu_torch.ops.cuda import brief, fastnms
from test_frontend import blob_image

torch.set_num_threads(2)
ATOL = 1e-5


def images():
    rng = np.random.default_rng(5)
    noisy = blob_image(rng, n=30)
    noisy += rng.uniform(0, 0.03, noisy.shape).astype(np.float32)
    return {
        "blobs": blob_image(np.random.default_rng(0), n=25),
        "noisy": noisy,
        # 3x3 squares, many of equal value: a tie-heavy score map
        "example": example_image(96, 128)[0],
    }


IMAGES = images()


def test_constants_match_reference():
    assert np.array_equal(tf._PATTERN, jf._PATTERN)
    assert tf._PATTERN.dtype == jf._PATTERN.dtype
    assert np.array_equal(tf.FAST_OFFSETS, jf.FAST_OFFSETS)
    assert tf.PATCH_R == jf.PATCH_R
    assert tf.DESC_WORDS == J_DESC_WORDS


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_blur_fast_nms_match_reference(name):
    img = IMAGES[name]
    t = torch.as_tensor(img)
    np.testing.assert_allclose(tf.gaussian_blur(t).numpy(),
                               np.asarray(jf.gaussian_blur(jnp.asarray(img))),
                               atol=ATOL)
    raw_j = np.asarray(jf.fast_score(jnp.asarray(img), 0.06))
    raw_t = tf.fast_score(t, 0.06)
    np.testing.assert_allclose(raw_t.numpy(), raw_j, atol=ATOL)
    nms_j = np.asarray(jf.nms(jnp.asarray(raw_j)))
    nms_t = tf.nms(torch.tensor(raw_j)).numpy()
    np.testing.assert_allclose(nms_t, nms_j, atol=ATOL)
    assert np.array_equal(nms_t > 0, nms_j > 0)
    assert (nms_j > 0).sum() > 0


@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("max_kps", [16, 128])
def test_select_keypoints_identical(name, max_kps):
    raw = np.asarray(jf.fast_score(jnp.asarray(IMAGES[name]), 0.06))
    score = np.asarray(jf.nms(jnp.asarray(raw)))
    uv_j, val_j, ok_j, n_j = jf.select_keypoints(
        jnp.asarray(score), max_kps=max_kps, raw_score=jnp.asarray(raw))
    uv_t, val_t, ok_t, n_t = tf.select_keypoints(
        torch.tensor(score), max_kps=max_kps,
        raw_score=torch.tensor(raw))
    # integer pixel positions identical, ties included
    np.testing.assert_array_equal(np.round(uv_t.numpy()),
                                  np.round(np.asarray(uv_j)))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=ATOL)
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert int(n_t) == int(n_j)


def test_select_keypoints_ties_break_by_lowest_index():
    # a flat plateau of equal maxima, more than one chunk can keep
    score = np.zeros((64, 96), np.float32)
    score[20:44:2, 20:76:2] = 1.0              # 336 equal scores
    uv_j, _, _, _ = jf.select_keypoints(jnp.asarray(score), max_kps=100)
    uv_t, _, _, _ = tf.select_keypoints(torch.as_tensor(score), max_kps=100)
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_orientations_match_reference(name):
    img = IMAGES[name]
    m10_j, m01_j = jf.orientation_map(jnp.asarray(img))
    m10_t, m01_t = tf.orientation_map(torch.as_tensor(img))
    # 31 x 31-tap sums of terms up to 15 in size, which largely cancel:
    # XLA may contract the multiply-adds into FMAs, so the two agree to
    # float32 rounding of the summands (~1e-6 x 1e3), not of the result
    np.testing.assert_allclose(m10_t.numpy(), np.asarray(m10_j), atol=1e-3)
    np.testing.assert_allclose(m01_t.numpy(), np.asarray(m01_j), atol=1e-3)
    # and the angles they give at the image's keypoints agree closely
    # (off the corners, on flat ground, both moments are rounding noise)
    f = jf.extract_features(jnp.asarray(img), max_kps=64)
    uv = np.asarray(f.uv)[np.asarray(f.valid)]
    a_j = np.asarray(jf.compute_orientations(jnp.asarray(img),
                                             jnp.asarray(uv)))
    a_t = tf.compute_orientations(torch.as_tensor(img),
                                  torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(a_t, a_j, atol=1e-4)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_brief_bit_exact_given_uv_and_angle(name):
    img = IMAGES[name]
    rng = np.random.default_rng(7)
    H, W = img.shape
    K = 96
    uv = rng.uniform([16, 16], [W - 17, H - 17], (K, 2)).astype(np.float32)
    uv[:8] = np.round(uv[:8]) + 0.5             # half-pixel centres
    ang = rng.uniform(-np.pi, np.pi, K).astype(np.float32)
    ang[:4] = [0.0, np.pi / 2, -np.pi / 2, np.pi]
    blur = np.asarray(jf.gaussian_blur(jnp.asarray(img)))
    d_j = np.asarray(jf.brief_descriptors(jnp.asarray(blur), jnp.asarray(uv),
                                          jnp.asarray(ang)))
    d_t = tf.brief_descriptors(torch.tensor(blur), torch.as_tensor(uv),
                               torch.as_tensor(ang))
    assert d_t.dtype == torch.int32
    np.testing.assert_array_equal(d_t.numpy().view(np.uint32), d_j)


def test_pack_bits_keeps_bit_31():
    bits = torch.zeros((2, 256), dtype=torch.bool)
    bits[0, 31] = True                          # sign bit of word 0
    bits[1, 32 * 7 + 31] = bits[1, 0] = True
    words = tf.pack_bits(bits).numpy().view(np.uint32)
    assert words[0, 0] == 2 ** 31
    assert words[1, 0] == 1 and words[1, 7] == 2 ** 31


@pytest.mark.parametrize("name,min_same_bits", [
    ("noisy", 0.999), ("example", 0.999), ("blobs", 0.99)])
def test_extract_features_matches_reference(name, min_same_bits):
    img = IMAGES[name]
    f_j = jf.extract_features(jnp.asarray(img), max_kps=128,
                              use_pallas=False)
    f_t = tf.extract_features(torch.as_tensor(img), max_kps=128,
                              use_kernels=False)
    assert int(f_t.count) == int(f_j.count) > 0
    np.testing.assert_array_equal(f_t.valid.numpy(), np.asarray(f_j.valid))
    np.testing.assert_allclose(f_t.uv.numpy(), np.asarray(f_j.uv), atol=1e-4)
    np.testing.assert_allclose(f_t.score.numpy(), np.asarray(f_j.score),
                               atol=ATOL)
    d_j = np.asarray(f_j.desc)
    d_t = f_t.desc.numpy().view(np.uint32)
    same = np.unpackbits(d_j.view(np.uint8)) == np.unpackbits(
        d_t.view(np.uint8))
    assert same.mean() >= min_same_bits


def test_example_map_slab_matches_reference():
    """example_inputs builds the same map slab as the reference's from
    the same numpy draws, with the port's own extractor."""
    img, cam, xyz, desc, valid, _ = j_example_inputs(H=96, W=128, M=192,
                                                     max_kps=64)
    from gslam_tpu_torch.models.graft import example_inputs

    t_img, t_cam, t_xyz, t_desc, t_valid, gen = example_inputs(
        96, 128, 192, 64, device="cpu")
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(img))
    np.testing.assert_array_equal(t_cam.numpy(), np.asarray(cam))
    np.testing.assert_allclose(t_xyz.numpy(), np.asarray(xyz), atol=1e-5)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(valid))
    d_j = np.asarray(desc)
    d_t = t_desc.numpy().view(np.uint32)
    np.testing.assert_array_equal(d_t[64:], d_j[64:])   # the distractors
    same = np.unpackbits(d_j.view(np.uint8)) == np.unpackbits(
        d_t.view(np.uint8))
    assert same.mean() >= 0.999
    assert isinstance(gen, torch.Generator)


def test_kernel_wrappers_take_plain_version_on_cpu():
    img = torch.as_tensor(IMAGES["blobs"])
    n0, b0 = fastnms.launches, brief.launches
    nms_w, raw_w = fastnms.fast_nms_raw(img, 0.06)
    raw_p = tf.fast_score(img, 0.06)
    assert torch.equal(raw_w, raw_p)
    assert torch.equal(nms_w, tf.nms(raw_p))
    uv, _, _, _ = tf.select_keypoints(nms_w, max_kps=32, raw_score=raw_w)
    ang = tf.compute_orientations(img, uv)
    blur = tf.gaussian_blur(img)
    d_w = brief.brief(blur, uv, torch.cos(ang), torch.sin(ang))
    assert torch.equal(d_w, tf.brief_descriptors(blur, uv, ang))
    f_k = tf.extract_features(img, max_kps=64, use_kernels=True)
    f_p = tf.extract_features(img, max_kps=64, use_kernels=False)
    for a, b in zip(f_k, f_p):
        assert torch.equal(a, b)
    assert (fastnms.launches, brief.launches) == (n0, b0)
