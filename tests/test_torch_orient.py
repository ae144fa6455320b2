"""The orientation kernel's arithmetic, on the CPU.

``csrc/orient.cu`` forms each keypoint's centroid moments from its
31 x 31 patch alone, in the order of the plain version's two separable
filters (``frontend.centroid_moments``: ``orientation_map`` read at the
keypoints).  A CUDA kernel cannot run here, so :func:`kernel_model`
repeats its order in numpy float32, every product and sum rounded on its
own, and must equal the plain version bit for bit, in both moments and
in the angle, at the main path's shapes (480 x 640, KITTI's 376 x 1241
and the eight levels of the ORB pyramid at 1.2) with the keypoints
``select_keypoints`` gives at 50 to 2000 a level, and at slots on the
centre's truncation, wrap and clamp rules and at the image corners.
The kernel itself is held to the plain version on the card in
``tests/test_torch_kernels.py``.  Also the CPU half of the wrapper's
contract: CPU tensors take the plain version and launch nothing, and
``extract_features`` on the CPU is the plain composition with or without
``use_kernels``.
"""

import numpy as np
import pytest
import torch

from gslam_tpu_torch.ops import frontend
from gslam_tpu_torch.ops.cuda import orient

torch.set_num_threads(2)

R = frontend.PATCH_R
# the ORB cell's pyramid: 8 levels at 1.2 of 376 x 1241, 2000 keypoints
ORB_LEVELS = frontend.pyramid_shapes(376, 1241, 8, 1.2)
ORB_BUDGETS = frontend.pyramid_budgets(ORB_LEVELS, 2000).tolist()


def kernel_model(img: np.ndarray, uv: np.ndarray):
    """(m01, m10) as ``csrc/orient.cu`` forms them: the centre by
    ``_gather2d``'s rule, pixels and rows outside the image +0, row sums
    then a fold of the rows, in the filters' tap order."""
    H, W = img.shape
    f32 = np.float32
    xi = uv[:, 0].astype(np.int32)                  # toward zero
    yi = uv[:, 1].astype(np.int32)
    xi = np.clip(np.where(xi < 0, xi + W, xi), 0, W - 1)
    yi = np.clip(np.where(yi < 0, yi + H, yi), 0, H - 1)
    pad = np.zeros((H + 2 * R, W + 2 * R), f32)
    pad[R:R + H, R:R + W] = img
    d = np.arange(2 * R + 1)
    p = pad[yi[:, None, None] + d[None, :, None],
            xi[:, None, None] + d[None, None, :]]   # (K, 31, 31)
    s10 = f32(-R) * p[:, :, 0]
    s01 = p[:, :, 0].copy()
    for j in range(1, 2 * R + 1):
        if j != R:
            s10 = s10 + f32(j - R) * p[:, :, j]
        s01 = s01 + p[:, :, j]
    rows = yi[:, None] - R + d[None, :]
    inside = (rows >= 0) & (rows < H)
    s10 = np.where(inside, s10, f32(0))
    s01 = np.where(inside, s01, f32(0))
    m10 = s10[:, 0].copy()
    m01 = f32(-R) * s01[:, 0]
    for i in range(1, 2 * R + 1):
        m10 = m10 + s10[:, i]
        if i != R:
            m01 = m01 + f32(i - R) * s01[:, i]
    assert m10.dtype == m01.dtype == f32
    return m01, m10


def textured(H, W, seed):
    """Blobs over a ramp with noise, a tenth of the pixels exactly 0."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 0.1, np.float32)
    img += np.linspace(0, 0.2, W, dtype=np.float32)[None, :]
    for _ in range(H * W // 400):
        cy, cx = rng.integers(4, H - 4), rng.integers(4, W - 4)
        r = int(rng.integers(1, 4))
        img[cy - r:cy + r, cx - r:cx + r] = rng.uniform(0.5, 1.0)
    img += rng.uniform(0, 0.03, img.shape).astype(np.float32)
    img[rng.uniform(size=img.shape) < 0.1] = 0.0
    return img


def keypoints(img, k):
    """``select_keypoints``' slots on a cheap score map (local maxima of
    the image less its 3 x 3 mean), subpixel-refined: valid slots inside
    the 16-px border, invalid ones wherever the selection leaves them."""
    x = torch.as_tensor(img)
    mean = torch.nn.functional.avg_pool2d(x[None, None], 3, 1, 1)[0, 0]
    raw = (x - mean).clamp_min(0.0)
    uv, _, valid, _ = frontend.select_keypoints(frontend.nms(raw),
                                                max_kps=k, raw_score=raw)
    return uv, valid


def edge_slots(H, W):
    """Centres on the rules: truncation of negatives toward zero, a
    negative index wrapped once, indices past the end clamped, the four
    corners, patches reaching past every border."""
    return torch.tensor([
        [0.0, 0.0], [W - 1.0, 0.0], [0.0, H - 1.0], [W - 1.0, H - 1.0],
        [-0.7, -0.99], [-1.0, -1.0], [-3.5, 5.25], [7.9, -2.0],
        [-W + 0.5, -H + 0.2], [W + 40.0, H + 3.0], [W - 0.01, H - 0.01],
        [1e6, -1e3], [14.9, 15.1], [W - 15.5, H - 16.0],
        [W / 2 + 0.99, H / 2 - 0.99]], dtype=torch.float32)


def assert_model_equals_plain(img, uv):
    m01_p, m10_p = frontend.centroid_moments(torch.as_tensor(img), uv)
    m01_m, m10_m = kernel_model(img, uv.numpy())
    assert m01_p.numpy().view(np.uint32).tolist() == \
        m01_m.view(np.uint32).tolist()
    assert m10_p.numpy().view(np.uint32).tolist() == \
        m10_m.view(np.uint32).tolist()
    angle = frontend.compute_orientations(torch.as_tensor(img), uv)
    model_angle = torch.atan2(torch.as_tensor(m01_m), torch.as_tensor(m10_m))
    assert torch.equal(angle.view(torch.int32), model_angle.view(torch.int32))


@pytest.mark.parametrize("shape,ks", [
    ((480, 640), (50, 512, 2000)),
    ((376, 1241), (50, 646, 2000)),
    *((s, (k,)) for s, k in zip(ORB_LEVELS[1:], ORB_BUDGETS[1:]))])
def test_kernel_order_equals_plain_bit_for_bit(shape, ks):
    H, W = shape
    img = textured(H, W, seed=H + W)
    for k in ks:
        uv, valid = keypoints(img, k)
        assert int(valid.sum()) > 0.5 * min(k, 50)
        assert_model_equals_plain(img, uv)
    assert_model_equals_plain(img, edge_slots(H, W))


def test_orb_levels_are_the_cell_s_shapes():
    assert ORB_LEVELS[0] == (376, 1241) and ORB_LEVELS[-1] == (105, 346)
    assert len(ORB_LEVELS) == 8 and sum(ORB_BUDGETS) == 2000
    assert ORB_BUDGETS[0] == 646


def test_kernel_order_on_a_flat_and_a_zero_image():
    """Exact cancellation: every moment of a flat patch sums to a signed
    zero, which decides atan2's sign; the model keeps the plain version's
    zeros."""
    for value in (0.0, 0.37):
        img = np.full((64, 80), value, np.float32)
        assert_model_equals_plain(img, edge_slots(64, 80))


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    img = textured(120, 160, seed=3)
    uv, _ = keypoints(img, 200)
    before = orient.launches
    got = orient.centroid_moments(torch.as_tensor(img), uv)
    want = frontend.centroid_moments(torch.as_tensor(img), uv)
    assert orient.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("levels", [1, 3])
def test_extract_features_on_the_cpu_is_the_plain_composition(levels):
    img = torch.as_tensor(textured(144, 192, seed=9))
    kw = dict(max_kps=256, threshold=0.08)
    if levels == 1:
        got = frontend.extract_features(img, **kw)
        plain = frontend.extract_features(img, use_kernels=False, **kw)
        raw = frontend.fast_score(img, kw["threshold"])
        uv, val, valid, count = frontend.select_keypoints(
            frontend.nms(raw), max_kps=kw["max_kps"], raw_score=raw)
        angle = frontend.compute_orientations(img, uv)
        desc = frontend.brief_descriptors(frontend.gaussian_blur(img), uv,
                                          angle)
        by_hand = frontend.Features(
            uv=uv, score=val, angle=torch.where(valid, angle, 0.0),
            desc=torch.where(valid[:, None], desc, 0), valid=valid,
            count=count)
        for a, b in zip(got, by_hand):
            assert torch.equal(a, b)
    else:
        got = frontend.extract_features_pyramid(img, n_levels=levels, **kw)
        plain = frontend.extract_features_pyramid(img, n_levels=levels,
                                                  use_kernels=False, **kw)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert int(got.count) > 20
