"""The mask test of the FAST kernel (B1, ``gslam_tpu_torch/csrc/fastnms.cu``)
held on the CPU, where there is no card.

The kernel passes a pixel on to the full test only where two consecutive
compass pixels (circle pixels 0, 4, 8, 12) are both bright or both dark.
The full test forms the 16 circle differences of a pixel, two 16-bit
masks (bright d > t, dark d < -t), the qualifying arc starts from
shift-ANDs of each mask doubled to 32 bits, and the arc sums only at
those starts, in arc order.  A numpy model of exactly that must give the port's plain
``fast_score`` bit for bit (the kernel is held to that plain version on
the card) and the JAX package's ``fast_score``, for arc 9 and arc 12:
the sums of starts that do not qualify never reach the plain score, and
each qualifying sum is the same sequence of float32 operations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import fast_case
from gslam_tpu.ops import frontend as jf
from gslam_tpu_torch.models.graft import example_image
from gslam_tpu_torch.ops import frontend as tf
from test_frontend import blob_image

torch.set_num_threads(2)


def arc_starts(m, arc):
    """The kernel's arc_starts: bit s set where bits s .. s + arc - 1
    (mod 16) of the 16-bit mask ``m`` are all set."""
    m = m.astype(np.uint32)
    x = m | (m << np.uint32(16))
    y = x & (x >> np.uint32(1))
    y &= y >> np.uint32(2)
    y &= y >> np.uint32(4)
    y &= (x >> np.uint32(8)) if arc == 9 else (y >> np.uint32(4))
    return y & np.uint32(0xFFFF)


def compass_pass(mb, md):
    """The kernel's compass_pass on the 16-bit masks: some two consecutive
    compass pixels both bright or both dark."""
    def compass(m):
        return sum(((m >> np.uint32(4 * i)) & np.uint32(1)) << np.uint32(i)
                   for i in range(4))
    ok = np.zeros(np.shape(mb), bool)
    for m in (compass(mb), compass(md)):
        ok |= (m & ((m >> np.uint32(1)) | (m << np.uint32(3)))
               & np.uint32(15)) != 0
    return ok


def masked_fast_score(img, threshold, arc):
    """The kernel's arithmetic in numpy float32: (score map, the number
    of arc sums formed)."""
    t = np.float32(threshold)
    H, W = img.shape
    d = np.stack([np.roll(img, (-int(dy), -int(dx)), (0, 1)) - img
                  for dx, dy in tf.FAST_OFFSETS])            # (16, H, W)
    bits = np.uint32(1) << np.arange(16, dtype=np.uint32)[:, None, None]
    mb = ((d > t) * bits).sum(0, dtype=np.uint32)
    md = ((d < -t) * bits).sum(0, dtype=np.uint32)
    passed = compass_pass(mb, md)
    mb, md = np.where(passed, mb, 0), np.where(passed, md, 0)
    score = np.zeros((H, W), np.float32)
    n_sums = 0
    for q, sign in ((arc_starts(mb, arc), 1), (arc_starts(md, arc), -1)):
        for s in range(16):
            ys, xs = np.nonzero((q >> np.uint32(s)) & np.uint32(1))
            acc = np.zeros(len(ys), np.float32)
            for k in range(arc):
                v = d[(s + k) % 16, ys, xs]
                acc = acc + ((v if sign > 0 else -v) - t)
            score[ys, xs] = np.maximum(score[ys, xs], acc)
            n_sums += len(ys)
    ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
    border = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return np.where(border, score, np.float32(0)), n_sums


def image(name):
    """(image, threshold): the images of tests/test_torch_frontend.py and
    the special cases of chip_smoke.fast_case."""
    if name == "blobs":
        return blob_image(np.random.default_rng(0), n=25), 0.06
    if name == "noisy":
        rng = np.random.default_rng(5)
        img = blob_image(rng, n=30)
        img += rng.uniform(0, 0.03, img.shape).astype(np.float32)
        return img, 0.06
    if name == "example":
        return example_image(96, 128)[0], 0.06
    return fast_case(name, 48, 72, seed=3)


NAMES = ["blobs", "noisy", "example", "ring", "boundary", "flat"]


@pytest.mark.parametrize("arc", [9, 12])
def test_arc_starts_every_mask(arc):
    """The shift-AND arc test against a direct scan, on all 65536
    masks."""
    m = np.arange(1 << 16, dtype=np.uint32)
    want = np.zeros_like(m)
    for s in range(16):
        run = np.ones_like(m, dtype=bool)
        for k in range(arc):
            run &= ((m >> np.uint32((s + k) % 16)) & np.uint32(1)) == 1
        want |= run.astype(np.uint32) << np.uint32(s)
    np.testing.assert_array_equal(arc_starts(m, arc), want)


@pytest.mark.parametrize("arc", [9, 12])
def test_compass_pretest_is_necessary(arc):
    """Every pair of masks with a qualifying arc passes the compass
    pretest, so a pixel it rejects scores 0 in the plain version too."""
    m = np.arange(1 << 16, dtype=np.uint32)
    qualifies = arc_starts(m, arc) != 0
    assert qualifies.any()
    assert compass_pass(m, np.zeros_like(m))[qualifies].all()
    assert compass_pass(np.zeros_like(m), m)[qualifies].all()


@pytest.mark.parametrize("arc", [9, 12])
@pytest.mark.parametrize("name", NAMES)
def test_mask_test_equals_plain_fast_score(name, arc):
    img, t = image(name)
    model, n_sums = masked_fast_score(img, t, arc)
    port = tf.fast_score(torch.as_tensor(img), t, arc).numpy()
    ref = np.asarray(jf.fast_score(jnp.asarray(img), t, arc))
    # bit for bit, the sign of zero included
    np.testing.assert_array_equal(model.view(np.uint32), port.view(np.uint32))
    np.testing.assert_array_equal(model.view(np.uint32), ref.view(np.uint32))
    H, W = img.shape
    assert n_sums < 16 * H * W * 0.25           # the sums the mask skips
    if name == "flat":
        assert n_sums == 0 and not model.any()
    elif arc == 9 or name == "ring":
        assert (model > 0).any()


@pytest.mark.parametrize("arc", [9, 12])
def test_ring_qualifies_at_every_start(arc):
    """Both ringed centres qualify at all 16 starts, and the 16 sums are
    not all equal: the score is their maximum, found among them."""
    img, t = fast_case("ring", 48, 72, seed=3)
    d = np.stack([np.roll(img, (-int(dy), -int(dx)), (0, 1)) - img
                  for dx, dy in tf.FAST_OFFSETS])
    model, _ = masked_fast_score(img, t, arc)
    for cy, cx, sign in ((16, 24, 1), (32, 48, -1)):
        v = sign * d[:, cy, cx]
        assert (v > t).all()
        sums = []
        for s in range(16):
            acc = np.float32(0)
            for k in range(arc):
                acc = acc + (v[(s + k) % 16] - np.float32(t))
            sums.append(acc)
        assert len(set(sums)) > 1
        assert model[cy, cx] == max(sums)


def test_boundary_image_meets_threshold_exactly():
    """The boundary case holds differences equal to +t and -t exactly,
    which count as neither bright nor dark."""
    img, t = fast_case("boundary", 48, 72, seed=3)
    d = np.stack([np.roll(img, (-int(dy), -int(dx)), (0, 1)) - img
                  for dx, dy in tf.FAST_OFFSETS])
    assert (d == np.float32(t)).sum() > 1000
    assert (d == -np.float32(t)).sum() > 1000
