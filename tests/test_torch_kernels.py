"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA card and ``nvcc`` and skips
without one; run them on a machine with a card by

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: this file imports neither JAX nor the JAX package,
so it runs where JAX is not installed).  Tolerances: FAST+NMS bit for
bit (float32 arc sums of the qualifying starts in the same order), BRIEF
bit for bit and the matchers exactly (integer arithmetic), as the
kernels' headers state.  The CPU half of the contract (a CPU tensor takes the
plain version) is in the frontend and matching test files.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    assert_schur_close, ba_case, fast_case, matcher_case, to_problem,
    without_pad_indices,
)
from gslam_tpu_torch.ops import frontend, matching
from gslam_tpu_torch.ops.cuda import brief, fastnms, matcher

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def blob_image(rng, H, W, n, r=3):
    img = np.full((H, W), 0.1, np.float32)
    for _ in range(n):
        cy = rng.integers(10, H - 10)
        cx = rng.integers(10, W - 10)
        img[cy - r:cy + r, cx - r:cx + r] = rng.uniform(0.6, 1.0)
    return img


@pytest.mark.parametrize("kind,shape,arc,r", [
    ("blob", (120, 160), 9, 3), ("blob", (97, 131), 9, 3),
    ("blob", (480, 640), 9, 3), ("blob", (480, 640), 12, 3),
    ("blob", (64, 70), 12, 1),  # 2x2 squares: every circle pixel darker
    ("ring", (40, 44), 9, 0), ("ring", (40, 44), 12, 0),
    ("boundary", (48, 72), 9, 0), ("boundary", (48, 72), 12, 0),
    ("noise", (7, 9), 9, 0), ("noise", (20, 33), 9, 0),
    ("noise", (20, 33), 12, 0), ("noise", (131, 97), 9, 0),
    ("flat", (30, 36), 9, 0)])
def test_fast_nms_kernel_matches_plain(dev, kind, shape, arc, r):
    """Both maps bit for bit: blob images (W a multiple of 4 or not),
    two centres whose 16 circle pixels all qualify, differences equal to
    +t and -t, shapes smaller than one tile and no corner at all."""
    rng = np.random.default_rng(1)
    if kind == "blob":
        img = blob_image(rng, *shape, n=shape[0] * shape[1] // 600, r=r)
        img += rng.uniform(0, 0.02, img.shape).astype(np.float32)
        t = 0.06
    else:
        img, t = fast_case(kind, *shape, seed=1)
    x = torch.as_tensor(img, device=dev)
    before = fastnms.launches
    nms_k, raw_k = fastnms.fast_nms_raw(x, t, arc)
    nms_p, raw_p = fastnms.fast_nms_plain(x, t, arc)
    again = fastnms.fast_nms_raw(x, t, arc)
    torch.cuda.synchronize()
    assert fastnms.launches == before + 2
    assert torch.equal(raw_k, raw_p)
    assert torch.equal(nms_k, nms_p)
    assert torch.equal(again[0], nms_k) and torch.equal(again[1], raw_k)
    if kind in ("blob", "ring"):
        assert (nms_k > 0).sum() > 0
    if kind == "flat":
        assert not raw_k.any()


def test_fast_nms_kernel_unaligned_image(dev):
    """An image that starts 4 bytes into its storage takes the 4-byte
    loads and stores, with the same bits."""
    rng = np.random.default_rng(2)
    img = blob_image(rng, 96, 128, n=20)
    flat = torch.zeros(96 * 128 + 1, device=dev)
    x = flat[1:].view(96, 128)
    x.copy_(torch.as_tensor(img, device=dev))
    nms_k, raw_k = fastnms.fast_nms_raw(x, 0.06)
    nms_p, raw_p = fastnms.fast_nms_plain(x, 0.06)
    torch.cuda.synchronize()
    assert torch.equal(raw_k, raw_p) and torch.equal(nms_k, nms_p)


@pytest.mark.parametrize("K", [1, 100, 512])
def test_brief_kernel_bit_exact(dev, K):
    rng = np.random.default_rng(2)
    H, W = 120, 160
    img = torch.as_tensor(blob_image(rng, H, W, n=40), device=dev)
    blur = frontend.gaussian_blur(img)
    # keypoints anywhere, the border included (endpoints are clamped)
    uv = torch.as_tensor(rng.uniform([-2, -2], [W + 1, H + 1], (K, 2))
                         .astype(np.float32), device=dev)
    ang = torch.as_tensor(rng.uniform(-np.pi, np.pi, K).astype(np.float32),
                          device=dev)
    ca, sa = torch.cos(ang), torch.sin(ang)
    before = brief.launches
    d_k = brief.brief(blur, uv, ca, sa)
    d_p = frontend.brief_from_rotation(blur, uv, ca, sa)
    torch.cuda.synchronize()
    assert brief.launches == before + 1
    assert torch.equal(d_k, d_p)


def random_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("N,M", [(2048, 512), (100, 300), (1, 2),
                                 (333, 1000), (512, 256)])
def test_matcher_kernel_matches_plain(dev, N, M):
    rng = np.random.default_rng(3)
    a = random_desc(rng, N)
    b = random_desc(rng, M)
    # duplicates: equal distances in rows and in columns
    if N > 4 and M > 4:
        b[1] = b[0]
        a[3] = a[2]
        a[:N // 4] = b[rng.integers(0, M, N // 4)].copy()
        a[:N // 8, 0] ^= 1
    va = rng.uniform(size=N) > 0.2
    vb = rng.uniform(size=M) > 0.2
    va[0] = vb[0] = True
    args = [torch.as_tensor(x, device=dev) for x in (a, va, b, vb)]
    before = matcher.launches
    out_k = matcher.hamming_top2_kernel(*args)
    out_p = matching.hamming_top2(*args)
    torch.cuda.synchronize()
    assert matcher.launches == before + 1
    for k, p in zip(out_k, out_p):
        assert torch.equal(k, p.to(k.dtype))
    for mutual in (True, False):
        m_k = matcher.match_hamming(*args, mutual=mutual)
        m_p = matching.match_descriptors(*args, mutual=mutual)
        assert torch.equal(m_k.idx, m_p.idx)
        assert torch.equal(m_k.valid, m_p.valid)
        assert torch.equal(m_k.dist, m_p.dist)


@pytest.mark.parametrize("kind", ["ties", "one_tile", "one_column"])
@pytest.mark.parametrize("N,M", [(333, 1000), (2048, 512), (512, 256),
                                 (65, 129), (40, 3), (1, 2)])
def test_matcher_kernel_across_tile_borders(dev, N, M, kind):
    """Equal minima 1 to 256 columns and rows apart (on both sides of the
    kernel's 128-column and 32-row tile borders), valid columns in one
    tile or one column only, masked rows and columns, shapes off the
    tile grid: equal to the plain version value for value, and the same
    bits from run to run."""
    args = [torch.as_tensor(x, device=dev)
            for x in matcher_case(N, M, kind, seed=N + M)]
    out_k = matcher.hamming_top2_kernel(*args)
    out_p = matching.hamming_top2(*args)
    again = matcher.hamming_top2_kernel(*args)
    torch.cuda.synchronize()
    for k, p, k2 in zip(out_k, out_p, again):
        assert torch.equal(k, p.to(k.dtype))
        assert torch.equal(k, k2)
    for mutual in (True, False):
        m_k = matcher.match_hamming(*args, max_dist=300.0, ratio=1.0,
                                    mutual=mutual)
        m_p = matching.match_descriptors(*args, max_dist=300.0, ratio=1.0,
                                         mutual=mutual)
        assert torch.equal(m_k.idx, m_p.idx)
        assert torch.equal(m_k.valid, m_p.valid)


def test_matcher_masked_column_points_to_row0(dev):
    rng = np.random.default_rng(4)
    a = torch.as_tensor(random_desc(rng, 70), device=dev)
    b = torch.as_tensor(random_desc(rng, 5), device=dev)
    va = torch.ones(70, dtype=torch.bool, device=dev)
    vb = torch.tensor([True, False, True, False, True], device=dev)
    best, second, idx, back = matcher.hamming_top2_kernel(a, va, b, vb)
    assert back[1].item() == 0 and back[3].item() == 0
    _, _, _, back_p = matching.hamming_top2(a, va, b, vb)
    assert torch.equal(back, back_p.to(back.dtype))


def test_wrappers_reject_bad_inputs(dev):
    img = torch.zeros((32, 40), device=dev)
    with pytest.raises(ValueError):
        fastnms.fast_nms_raw(img.double())
    with pytest.raises(ValueError):
        fastnms.fast_nms_raw(img.t())                # not contiguous
    with pytest.raises(ValueError):
        brief.brief(img, torch.zeros((3, 2), device=dev),
                    torch.zeros(4, device=dev), torch.zeros(3, device=dev))
    d = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    v = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        matcher.hamming_top2_kernel(d.long(), v, d, v)
    with pytest.raises(ValueError):
        matcher.hamming_top2_kernel(d, v.cpu(), d, v)


# ---------------------------------------------------------------------------
# B4 gated matcher, B5 Schur reduction, B6 BA cost


def gated_case(rng, N, M, gate, kind="near"):
    """``near``: half the keypoints near copies of map rows within the
    gate, two tied keypoints, one keypoint exactly on the gate of row 2.
    ``masked``: the same with every map row masked.  ``ties``: keypoints
    duplicated (descriptor and pixel) 1, 64, 128, 512 and 1024 columns
    apart, each matched by rows in different warps and blocks of the
    kernel, so equal minima meet across its row groups and column
    tiles."""
    a = random_desc(rng, N)
    b = random_desc(rng, M)
    va = rng.uniform(size=N) > 0.1
    vb = rng.uniform(size=M) > 0.1
    uv_a = rng.uniform(0, 200, (N, 2)).astype(np.float32)
    uv_b = rng.uniform(0, 200, (M, 2)).astype(np.float32)
    k = min(N, M) // 2
    b[:k] = a[:k]
    b[:k, 0] ^= 7
    uv_b[:k] = uv_a[:k] + rng.uniform(-0.6, 0.6, (k, 2)).astype(
        np.float32) * gate
    if k + 1 < M:
        b[k + 1] = b[k]                  # tied keypoints
        uv_b[k] = uv_b[k + 1] = uv_a[0]
    if N > 2 and M > 2:
        uv_b[2] = uv_a[2] + np.asarray([gate, 0], np.float32)   # on the gate
    if kind == "masked":
        va[:] = False
    elif kind == "ties":
        rows = iter(range(N - 1, 0, -7))
        for c, gap in ((3, 1), (5, 64), (10, 128), (20, 512), (40, 1024)):
            if c + gap < M:
                b[c + gap], uv_b[c + gap] = b[c], uv_b[c]
                vb[c] = vb[c + gap] = True
                for _ in range(3):
                    r = next(rows)
                    a[r], uv_a[r], va[r] = b[c], uv_b[c], True
                    a[r, 5] ^= np.int32(1 << r % 3)
    return a, va, b, vb, uv_a, uv_b


@pytest.mark.parametrize("N,M,gate,kind", [
    (2048, 512, 40.0, "near"), (100, 700, 25.0, "near"),
    (33, 6, 40.0, "near"), (1, 3, 10.0, "near"),
    (768, 384, 40.0, "near"), (1001, 2500, 40.0, "near"),
    (17, 1, 300.0, "near"), (2048, 512, 40.0, "masked"),
    (70, 300, 40.0, "masked"), (2048, 1200, 300.0, "ties"),
    (333, 2500, 300.0, "ties")])
def test_gated_kernel_matches_plain(dev, N, M, gate, kind):
    """Value for value against the plain version, and the same bits from
    run to run: the main path's and the loop run's shapes, M above the
    staging tile, N off the rows a block takes, one keypoint, every row
    masked, ties across row groups and column tiles."""
    rng = np.random.default_rng(5)
    args = [torch.as_tensor(x, device=dev)
            for x in gated_case(rng, N, M, gate, kind)]
    g2 = matching.gate_squared(gate)
    before = matcher.gated_launches
    out_k = matcher.gated_top2_kernel(*args, g2)
    out_p = matching.hamming_top2_gated(*args, g2)
    again = matcher.gated_top2_kernel(*args, g2)
    torch.cuda.synchronize()
    assert matcher.gated_launches == before + 2
    for k, p, k2 in zip(out_k, out_p, again):
        assert torch.equal(k, p.to(k.dtype))
        assert torch.equal(k, k2)
    if kind == "masked":
        assert (out_k[0] == 257).all() and (out_k[2] == 0).all()
    if kind == "ties":
        assert int((out_p[0] == out_p[1]).sum()) >= 5
    m_k = matcher.match_hamming_gated(*args, gate, ratio=0.85)
    m_p = matching.match_descriptors_gated(*args, gate, ratio=0.85)
    assert torch.equal(m_k.idx, m_p.idx) and torch.equal(m_k.valid,
                                                         m_p.valid)


def ba_problem(rng, C, P, O, dev):
    """tests/test_pallas.py's problem, in numpy: noisy projections, a
    fixed camera and point, invalid slots, a point behind every camera,
    non-uniform weights."""
    from gslam_tpu_torch.core.se3 import se3_apply
    from gslam_tpu_torch.opt.ba import BundleProblem

    cam_t = rng.normal(0, 0.2, (C, 3))
    q = np.tile([1.0, 0, 0, 0], (C, 1)) + rng.normal(0, 0.05, (C, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cam = torch.tensor(np.concatenate([cam_t, q], 1), dtype=torch.float32)
    pts = rng.normal(0, 1.0, (P, 3)).astype(np.float32)
    pts[:, 2] += 5
    pts[3] = [0, 0, -5]
    obs_cam = rng.integers(0, C, (P, O)).astype(np.int32)
    pc = se3_apply(cam[torch.tensor(obs_cam).long()],
                   torch.tensor(pts)[:, None]).numpy()
    z = np.maximum(pc[..., 2], 1e-3)
    uv = (pc[..., :2] / z[..., None]
          + rng.normal(0, 2e-3, (P, O, 2))).astype(np.float32)
    cam_fixed = np.zeros(C, bool)
    cam_fixed[0] = True
    pt_fixed = np.zeros(P, bool)
    pt_fixed[min(7, P - 1)] = True
    fields = (cam.numpy(), cam_fixed, pts, pt_fixed, obs_cam, uv,
              rng.random((P, O)) < 0.85,
              (rng.random((P, O)) + 0.5).astype(np.float32))
    return BundleProblem(*(torch.as_tensor(x, device=dev) for x in fields))


@pytest.mark.parametrize("C,P,O", [(8, 1024, 8), (3, 137, 5), (32, 300, 4),
                                   (1, 5, 1)])
def test_schur_and_cost_kernels_match_plain(dev, C, P, O):
    from gslam_tpu_torch.ops.cuda import schur
    from gslam_tpu_torch.opt import ba

    prob = ba_problem(np.random.default_rng(C + P), C, P, O, dev)
    lam = torch.tensor(1e-3, device=dev)
    b5, b6 = schur.schur_launches, schur.cost_launches
    out_k = schur.schur_reduce_kernel(prob, lam, 0.01)
    cost_k = schur.ba_cost_kernel(prob, 0.01)
    out_p = ba.schur_reduce(prob, lam, 0.01)
    cost_p = ba.ba_cost(prob, 0.01)
    torch.cuda.synchronize()
    assert (schur.schur_launches, schur.cost_launches) == (b5 + 1, b6 + 1)
    (S1, b1, W1, Hi1, bp1), (S0, b0, W0, Hi0, bp0) = out_k, out_p
    # tests/test_pallas.py's tolerances for the Schur kernel
    torch.testing.assert_close(S1, S0, rtol=1e-4,
                               atol=1e-4 * S0.abs().max().item())
    torch.testing.assert_close(b1, b0, rtol=0, atol=1e-4 * max(
        b0.abs().max().item(), 1e-6))
    torch.testing.assert_close(W1.W_e, W0.W_e, rtol=0, atol=1e-4)
    torch.testing.assert_close(Hi1, Hi0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(bp1, bp0, rtol=0, atol=1e-5)
    torch.testing.assert_close(cost_k, cost_p, rtol=1e-5, atol=0)
    # the same inputs give the same bits: no float atomics
    again = schur.schur_reduce_kernel(prob, lam, 0.01)
    assert torch.equal(again[0], S1) and torch.equal(again[1], b1)


def test_schur_and_cost_kernels_clamp_pad_camera_index(dev):
    """Invalid slots whose camera index is -1 or C (pads) read inside the
    camera table: the kernels give what the plain version gives with
    those pads set to camera 0."""
    from gslam_tpu_torch.ops.cuda import schur
    from gslam_tpu_torch.opt import ba

    C, P, O = 4, 64, 3
    prob = ba_problem(np.random.default_rng(5), C, P, O, dev)
    pad = torch.zeros((P, O), dtype=torch.bool, device=dev)
    pad[::3, 1] = True
    valid = prob.obs_valid & ~pad
    padded = prob._replace(obs_valid=valid, obs_cam=torch.where(
        pad, torch.where(torch.arange(P, device=dev)[:, None] % 2 == 0,
                         -1, C), prob.obs_cam).to(torch.int32))
    plain = prob._replace(obs_valid=valid, obs_cam=torch.where(
        pad, 0, prob.obs_cam).to(torch.int32))
    lam = torch.tensor(1e-3, device=dev)
    out_k = schur.schur_reduce_kernel(padded, lam, 0.01)
    cost_k = schur.ba_cost_kernel(padded, 0.01)
    out_p = ba.schur_reduce(plain, lam, 0.01)
    cost_p = ba.ba_cost(plain, 0.01)
    (S1, b1, W1, Hi1, bp1), (S0, b0, W0, Hi0, bp0) = out_k, out_p
    torch.testing.assert_close(S1, S0, rtol=1e-4,
                               atol=1e-4 * S0.abs().max().item())
    torch.testing.assert_close(b1, b0, rtol=0, atol=1e-4 * max(
        b0.abs().max().item(), 1e-6))
    torch.testing.assert_close(W1.W_e, W0.W_e, rtol=0, atol=1e-4)
    torch.testing.assert_close(Hi1, Hi0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(bp1, bp0, rtol=0, atol=1e-5)
    torch.testing.assert_close(cost_k, cost_p, rtol=1e-5, atol=0)


@pytest.mark.parametrize("C,P,O,window,pads", [
    (32, 1024, 8, 6, True), (32, 96, 8, 5, True), (4, 384, 8, 4, False),
    (8, 61, 5, 3, True), (32, 300, 16, 32, False), (2, 9, 300, 2, True),
    (2, 5, 600, 2, True)])
def test_schur_kernel_sparse_repeated_and_padded(dev, C, P, O, window, pads):
    """Few cameras per point, one camera in two slots, pad slots with the
    camera index -1 or C, O off the warp size, P off the group size, more
    slots than a block has threads: within tests/test_pallas.py's
    tolerances of the plain version (pads set to camera 0 there), and
    the same bits in every output from run to run."""
    from gslam_tpu_torch.ops.cuda import schur
    from gslam_tpu_torch.opt import ba

    fields = ba_case(C, P, O, seed=C + P + O, window=window, pads=pads)
    lam = torch.tensor(1e-3, device=dev)
    prob = to_problem(fields, dev)
    out_k = schur.schur_reduce_kernel(prob, lam, 0.01)
    again = schur.schur_reduce_kernel(prob, lam, 0.01)
    plain = to_problem(without_pad_indices(fields), dev)
    out_p = ba.schur_reduce(plain, lam, 0.01)
    torch.cuda.synchronize()
    assert_schur_close(out_k, out_p, f"C={C}, P={P}, O={O}")
    for x, y in zip((out_k[0], out_k[1], out_k[2].W_e, out_k[3], out_k[4]),
                    (again[0], again[1], again[2].W_e, again[3], again[4])):
        assert torch.equal(x, y)
    torch.testing.assert_close(schur.ba_cost_kernel(prob, 0.01),
                               ba.ba_cost(plain, 0.01), rtol=1e-5, atol=0)


def test_schur_scratch_stays_small(dev):
    """The scratch is the blocks' partials: under 12 MB at the widest
    camera count, and no larger for sixteen times the points."""
    from gslam_tpu_torch.ops.cuda import schur

    lib = schur._lib()
    at_32 = lib.gslam_schur_scratch(32, 1024) * 4
    assert at_32 < 12e6
    assert lib.gslam_schur_scratch(32, 16384) * 4 == at_32
    assert lib.gslam_schur_scratch(8, 1024) * 4 < 3e6


def test_bundle_adjust_kernels_follow_plain_lm_path(dev):
    from gslam_tpu_torch.opt import ba

    prob = ba_problem(np.random.default_rng(0), 8, 1024, 8, dev)
    out_k, st_k = ba.bundle_adjust(prob, iters=6, use_kernels=True)
    out_p, st_p = ba.bundle_adjust(prob, iters=6, use_kernels=False)
    assert torch.equal(st_k.accepted, st_p.accepted)
    torch.testing.assert_close(st_k.cost, st_p.cost, rtol=1e-3, atol=0)
    torch.testing.assert_close(out_k.cam_pose, out_p.cam_pose, rtol=0,
                               atol=1e-4)


def test_schur_wrapper_rejects_too_many_cameras(dev):
    from gslam_tpu_torch.ops.cuda import schur

    prob = ba_problem(np.random.default_rng(1), 33, 40, 2, dev)
    with pytest.raises(ValueError, match="cameras"):
        schur.schur_reduce_kernel(prob, torch.tensor(1e-3, device=dev))
    prob = to_problem(ba_case(2, 3, schur.MAX_OBS + 1), dev)
    with pytest.raises(ValueError, match="slots"):
        schur.schur_reduce_kernel(prob, torch.tensor(1e-3, device=dev))


# ---------------------------------------------------------------------------
# B7 BoW tree descent


def random_tree(rng, k, L, dev):
    """A complete tree of random centres with duplicated siblings (tied
    distances at every level)."""
    from gslam_tpu_torch.ops.vocab import _level_offset

    nodes = random_desc(rng, _level_offset(k, L + 1))
    for l in range(1, L + 1):       # each level's second node = its first
        off = _level_offset(k, l)
        nodes[off + 1] = nodes[off]
    return torch.as_tensor(nodes, device=dev)


@pytest.mark.parametrize("k,L,N", [(3, 3, 173), (6, 2, 384), (8, 4, 513),
                                   (10, 2, 1), (40, 2, 257)])
def test_vocab_kernel_equals_plain(dev, k, L, N):
    from gslam_tpu_torch.ops.cuda import vocab as vocab_k
    from gslam_tpu_torch.ops.vocab import _level_offset, _transform_words

    rng = np.random.default_rng(k * 100 + L)
    nodes = random_tree(rng, k, L, dev)
    desc = random_desc(rng, N)
    # some descriptors are node centres themselves (distance 0, and tied
    # where the centre is duplicated)
    pick = rng.integers(0, _level_offset(k, L + 1), max(N // 3, 1))
    desc[:len(pick)] = nodes.cpu().numpy()[pick]
    valid = rng.uniform(size=N) > 0.15
    d = torch.as_tensor(desc, device=dev)
    v = torch.as_tensor(valid, device=dev)
    before = vocab_k.launches
    w_k = vocab_k.transform_words_kernel(nodes, d, v, k, L)
    w_p = _transform_words(nodes, d, v, k, L)
    torch.cuda.synchronize()
    assert vocab_k.launches == before + 1
    assert w_k.dtype == torch.int32 and torch.equal(w_k, w_p)
    assert torch.equal(w_k < 0, ~v)
    assert int(w_k.max()) < k ** L
    again = vocab_k.transform_words_kernel(nodes, d, v, k, L)
    assert torch.equal(again, w_k)


def test_transform_words_routes_by_tree_layout(dev):
    """A complete tree on the card goes through the kernel, a general
    tree through the PyTorch descent; both give the same words when the
    general tree spells out the complete one."""
    from gslam_tpu_torch.ops import vocab
    from gslam_tpu_torch.ops.cuda import vocab as vocab_k

    rng = np.random.default_rng(9)
    k, L, N = 5, 3, 300
    nodes = random_tree(rng, k, L, dev)
    n_nodes = nodes.shape[0]
    first_leaf = vocab._level_offset(k, L)
    voc = vocab.Vocabulary(nodes, torch.ones(k ** L, device=dev), k, L)
    children = np.full((n_nodes, k), -1, np.int32)
    inner = np.arange(first_leaf)
    children[inner] = inner[:, None] * k + 1 + np.arange(k)
    leaf_word = np.full(n_nodes, -1, np.int32)
    leaf_word[first_leaf:] = np.arange(k ** L)
    general = voc._replace(children=torch.as_tensor(children, device=dev),
                           leaf_word=torch.as_tensor(leaf_word, device=dev))
    d = torch.as_tensor(random_desc(rng, N), device=dev)
    v = torch.ones(N, dtype=torch.bool, device=dev)
    before = vocab_k.launches
    w_c = vocab.transform_words(voc, d, v, use_kernels=True)
    assert vocab_k.launches == before + 1
    w_g = vocab.transform_words(general, d, v, use_kernels=True)
    assert vocab_k.launches == before + 1
    assert torch.equal(w_c, w_g)


def test_vocab_wrapper_rejects_bad_inputs(dev):
    from gslam_tpu_torch.ops.cuda import vocab as vocab_k

    rng = np.random.default_rng(10)
    nodes = random_tree(rng, 4, 2, dev)
    d = torch.as_tensor(random_desc(rng, 7), device=dev)
    v = torch.ones(7, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        vocab_k.transform_words_kernel(nodes[:-1], d, v, 4, 2)   # not complete
    with pytest.raises(ValueError):
        vocab_k.transform_words_kernel(nodes, d.long(), v, 4, 2)
    with pytest.raises(ValueError):
        vocab_k.transform_words_kernel(nodes, d, v.cpu(), 4, 2)
    with pytest.raises(ValueError):
        vocab_k.transform_words_kernel(nodes, d[:0], v[:0], 4, 2)
    with pytest.raises(ValueError):
        vocab_k.transform_words_kernel(nodes, d, v, 1, 2)
