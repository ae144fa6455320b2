"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA card and ``nvcc`` and skips
without one; run them on a machine with a card by

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: this file imports neither JAX nor the JAX package,
so it runs where JAX is not installed).  Tolerances: FAST+NMS bit for
bit (float32 arc sums of the qualifying starts in the same order), BRIEF
bit for bit and the matchers exactly (integer arithmetic), the BA cost
within rtol 1e-5 of its plain version and bit for bit its float32 model
(``chip_smoke.cost_order``: the kernel's fixed summation order), as the
kernels' headers state.  The CPU half of the contract (a CPU tensor takes the
plain version) is in the frontend and matching test files.
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import (
    FR1_ARGS, LENS_ARGS, LENS_PX_TOL, LENS_RAY_TOL, REMAP_TOL,
    assemble_partials, assert_partials_close, assert_schur_close, ba_case,
    border_only, cost_order, extract_captures, fast_case, lens_camera,
    lens_points, matcher_case, pixel_grid, rotated_rig, to_problem, vi_case,
    without_pad_indices,
)
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.undistort import StereoRectifier, Undistorter, _remap
from gslam_tpu_torch.ops import frontend, matching
from gslam_tpu_torch.ops.cuda import brief, fastnms, matcher, orient
from test_torch_orient import ORB_BUDGETS, ORB_LEVELS, edge_slots

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


def vga_pyramid(dev, scale=1.25, n_levels=3):
    """The three-level pyramid of a textured VGA blob image, as
    extract_features_pyramid forms it on the card, and the levels'
    keypoint budgets at max_kps 512."""
    rng = np.random.default_rng(4)
    img = blob_image(rng, 480, 640, n=640)
    img += rng.uniform(0, 0.03, img.shape).astype(np.float32)
    levels = frontend.image_pyramid(torch.as_tensor(img, device=dev),
                                    n_levels=n_levels, scale=scale)
    return levels, frontend.pyramid_budgets([x.shape for x in levels], 512)


def test_fast_nms_kernel_at_pyramid_levels(dev):
    """Both maps bit for bit on the pyramid's levels, 384x512 and 307x410
    (a width that is not a multiple of 4: the 4-byte loads)."""
    levels, _ = vga_pyramid(dev)
    assert [tuple(x.shape) for x in levels] == [(480, 640), (384, 512),
                                                (307, 410)]
    for lvl in levels[1:]:
        before = fastnms.launches
        nms_k, raw_k = fastnms.fast_nms_raw(lvl, 0.08)
        nms_p, raw_p = fastnms.fast_nms_plain(lvl, 0.08)
        torch.cuda.synchronize()
        assert fastnms.launches == before + 1
        assert torch.equal(raw_k, raw_p) and torch.equal(nms_k, nms_p)
        assert int((nms_k > 0).sum()) > 100


def test_brief_kernel_at_pyramid_budgets(dev):
    """Bit for bit at each level of the VGA pyramid with its budget of
    the 512 keypoints (250, 160 and 102), as extract_features forms
    the inputs."""
    levels, ks = vga_pyramid(dev)
    assert ks.tolist() == [250, 160, 102]
    for lvl, k in zip(levels, ks):
        nms, raw = fastnms.fast_nms_plain(lvl, 0.08)
        uv, _, valid, _ = frontend.select_keypoints(nms, max_kps=int(k),
                                                    raw_score=raw)
        ang = frontend.compute_orientations(lvl, uv)
        blur = frontend.gaussian_blur(lvl)
        args = (blur, uv, torch.cos(ang), torch.sin(ang))
        before = brief.launches
        d_k = brief.brief(*args)
        d_p = frontend.brief_from_rotation(*args)
        torch.cuda.synchronize()
        assert brief.launches == before + 1
        assert torch.equal(d_k, d_p) and int(valid.sum()) > 0.8 * k


def kitti_image(dev, seed=6):
    """A textured blob image at KITTI's 376 x 1241 on the card."""
    rng = np.random.default_rng(seed)
    img = blob_image(rng, 376, 1241, n=1500)
    img += rng.uniform(0, 0.03, img.shape).astype(np.float32)
    return torch.as_tensor(img, device=dev)


@pytest.mark.parametrize("cell,max_kps,n_levels,scale", [
    ("vga", 512, 3, 1.25), ("kitti_orb", 2000, 8, 1.2)])
def test_extract_features_pyramid_kernels_equal_plain(dev, cell, max_kps,
                                                      n_levels, scale):
    """Every feature bit for bit, one B1, orientation and B2 launch a
    level: the VGA pyramid, and the ORB cell's 2000 keypoints over 8
    levels at 1.2 on 376 x 1241."""
    img = vga_pyramid(dev)[0][0] if cell == "vga" else kitti_image(dev)
    kw = dict(max_kps=max_kps, threshold=0.08, n_levels=n_levels,
              scale=scale)
    before = (fastnms.launches, orient.launches, brief.launches)
    f_k = frontend.extract_features_pyramid(img, **kw)
    f_p = frontend.extract_features_pyramid(img, use_kernels=False, **kw)
    assert (fastnms.launches, orient.launches, brief.launches) == tuple(
        b + n_levels for b in before)
    for a, b in zip(f_k, f_p):
        assert torch.equal(a, b)
    assert int(f_k.count) > 0.5 * max_kps


def orient_image(dev, shape):
    """A textured blob image of ``shape`` on the card: VGA, KITTI, or a
    level of the ORB pyramid of the KITTI image."""
    if shape == (480, 640):
        return vga_pyramid(dev)[0][0]
    levels = frontend.image_pyramid(kitti_image(dev), n_levels=8, scale=1.2)
    return levels[ORB_LEVELS.index(shape)]


@pytest.mark.parametrize("shape", [(480, 640), *ORB_LEVELS])
def test_orientation_kernel_bit_exact(dev, shape):
    """Both moments and the angle bit for bit against the plain version
    at the keypoints B1 and select_keypoints give at K = 1, 8, 646, 2000
    and the level's ORB budget, and at slots on the centre's wrap and
    clamp rules and the corners; one launch a call."""
    img = orient_image(dev, shape)
    assert tuple(img.shape) == shape
    nms, raw = fastnms.fast_nms_plain(img, 0.08)
    budget = dict(zip(ORB_LEVELS, ORB_BUDGETS)).get(shape, 512)
    for K in (1, 8, 646, 2000, budget):
        uv, _, valid, _ = frontend.select_keypoints(nms, max_kps=K,
                                                    raw_score=raw)
        for pts in (uv, edge_slots(*shape).to(dev)):
            before = orient.launches
            m_k = orient.centroid_moments(img, pts)
            torch.cuda.synchronize()
            assert orient.launches == before + 1
            m_p = frontend.centroid_moments(img, pts)
            for a, b in zip(m_k, m_p):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert torch.equal(torch.atan2(*m_k),
                               frontend.compute_orientations(img, pts))
        assert int(valid.sum()) >= min(K, 40)


def test_orientation_kernel_same_bits_over_calls_and_graph_replays(dev):
    """The same bits from two calls, from a call on other inputs between
    them, and from two replays of a CUDA graph holding two calls."""
    img = kitti_image(dev)
    nms, raw = fastnms.fast_nms_plain(img, 0.08)
    uv = frontend.select_keypoints(nms, max_kps=2000, raw_score=raw)[0]
    small = orient_image(dev, ORB_LEVELS[-1])
    first = orient.centroid_moments(img, uv)
    other = orient.centroid_moments(small, uv[:50])
    again = orient.centroid_moments(img, uv)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        orient.centroid_moments(img, uv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = orient.launches
    with torch.cuda.graph(graph):
        o1 = orient.centroid_moments(img, uv)
        o2 = orient.centroid_moments(small, uv[:50])
    assert orient.launches == before + 2       # counted at capture
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(([t.clone() for t in o1], [t.clone() for t in o2]))
    for a, b in replays:
        assert all(torch.equal(x, y) for x, y in zip(a, first))
        assert all(torch.equal(x, y) for x, y in zip(b, other))
    assert all(torch.equal(x, y) for x, y in zip(again, first))


@pytest.mark.parametrize("H,W,K,margin", [
    (120, 160, 1, 2), (120, 160, 100, 2), (120, 160, 512, 2),
    *((480, 640, K, 40) for K in (1, 3, 383, 384, 512, 1000))])
def test_brief_kernel_bit_exact(dev, H, W, K, margin):
    """Bit for bit, with keypoints up to ``margin`` px past every border
    (endpoints clamped), at 480 x 640 with K on and off the keypoints a
    block takes."""
    rng = np.random.default_rng(2)
    img = torch.as_tensor(blob_image(rng, H, W, n=H * W // 480), device=dev)
    blur = frontend.gaussian_blur(img)
    uv = torch.as_tensor(rng.uniform([-margin, -margin],
                                     [W + margin - 1, H + margin - 1],
                                     (K, 2)).astype(np.float32), device=dev)
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
    uv = torch.zeros((3, 2), device=dev)
    for bad_img, bad_uv in ((img.double(), uv), (img.t(), uv),
                            (img, uv.double()), (img, uv.t()),
                            (img, uv[:, :1]), (img, uv.cpu()),
                            (img[None], uv)):
        with pytest.raises(ValueError):
            orient.centroid_moments(bad_img, bad_uv)
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
    assert_schur_close(out_k, out_p, plain, f"C={C}, P={P}, O={O}")
    for x, y in zip((out_k[0], out_k[1], out_k[2].W_e, out_k[3], out_k[4]),
                    (again[0], again[1], again[2].W_e, again[3], again[4])):
        assert torch.equal(x, y)
    torch.testing.assert_close(schur.ba_cost_kernel(prob, 0.01),
                               ba.ba_cost(plain, 0.01), rtol=1e-5, atol=0)


@pytest.mark.parametrize("C,P,O,window,pads,shard", [
    (4, 384, 8, 4, False, False), (8, 1024, 8, 8, False, False),
    (32, 1024, 8, 6, True, False), (29, 1200, 16, 6, True, True),
    (6, 61, 5, 3, True, True)])
def test_schur_partials_kernel_matches_plain(dev, C, P, O, window, pads,
                                             shard):
    """B5's partials entry against its plain version (schur_partials:
    undamped, unpinned Hcc, bvec = bc - b_corr, S_corr), also on a ring
    shard with pad cameras (rank 1 of 4: C padded to a multiple of 4
    with fixed identity poses, C_pad <= 32) and with pad slots; one
    launch counted; the same bits twice; pad cameras' rows zero."""
    from gslam_tpu_torch.ops.cuda import schur
    from gslam_tpu_torch.parallel.dist_ba import ring_shard

    fields = ba_case(C, P, O, seed=C + P, window=window, pads=pads)
    lam = torch.tensor(1e-3, device=dev)
    prob, plain = (to_problem(f, dev) for f in (fields,
                                                without_pad_indices(fields)))
    if shard:
        prob, plain = (ring_shard(x, 4, 1) for x in (prob, plain))
    n = schur.partials_launches
    out_k = schur.schur_partials_kernel(prob, lam, 0.01)
    again = schur.schur_partials_kernel(prob, lam, 0.01)
    out_p = schur.schur_partials_plain(plain, lam, 0.01)
    torch.cuda.synchronize()
    assert schur.partials_launches == n + 2
    assert_partials_close(out_k, out_p, plain,
                          f"C={prob.cam_pose.shape[0]}, P={P}")
    flat = lambda o: (o[0], o[1], o[2], o[3].W_e, o[4], o[5])  # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(flat(out_k), flat(again)))
    assert not out_k[2][6 * C:].any() and not out_k[0][C:].any()


@pytest.mark.parametrize("C,P,O", [(8, 1024, 8), (32, 1024, 8), (4, 384, 8)])
def test_schur_partials_assemble_to_the_schur_kernel(dev, C, P, O):
    """Damped and pinned, the partials of the whole problem are
    gslam_schur's S and b bit for bit (the same sums in the same order);
    the partials of four point blocks, summed, are within
    tests/test_pallas.py's tolerances of them."""
    from gslam_tpu_torch.ops.cuda import schur

    fields = ba_case(C, P, O, seed=3, window=6, pads=True)
    lam = torch.tensor(1e-3, device=dev)
    prob = to_problem(fields, dev)
    S, b = schur.schur_reduce_kernel(prob, lam, 0.01)[:2]
    S1, b1 = assemble_partials(schur.schur_partials_kernel(prob, lam, 0.01),
                               lam, prob.cam_fixed)
    assert torch.equal(S1, S) and torch.equal(b1, b)
    blk = P // 4
    parts = [schur.schur_partials_kernel(prob._replace(
        point_xyz=prob.point_xyz[k:k + blk],
        point_fixed=prob.point_fixed[k:k + blk],
        obs_cam=prob.obs_cam[k:k + blk], obs_uv=prob.obs_uv[k:k + blk],
        obs_valid=prob.obs_valid[k:k + blk],
        obs_weight=prob.obs_weight[k:k + blk]), lam, 0.01)
        for k in range(0, P, blk)]
    summed = [sum(p[i] for p in parts) for i in range(3)]
    S4, b4 = assemble_partials(summed, lam, prob.cam_fixed)
    torch.testing.assert_close(S4, S, rtol=1e-4,
                               atol=1e-4 * S.abs().max().item())
    torch.testing.assert_close(b4, b, rtol=0,
                               atol=1e-4 * max(b.abs().max().item(), 1e-6))


def ring_rank(rank, world, fields, iters):
    """One rank of the ring BA with the kernels (launch.spawn)."""
    from gslam_tpu_torch.ops.cuda import schur
    from gslam_tpu_torch.parallel import (
        distributed_bundle_adjust_ring, make_mesh,
    )

    out, costs = distributed_bundle_adjust_ring(
        to_problem(fields, "cuda"), make_mesh((world, 1), device="cuda"),
        iters=iters, use_kernels=True)
    return out.cam_pose, costs, schur.partials_launches, schur.cost_launches


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_ring_with_kernels_matches_single_device(dev, world, backend):
    """The ring BA with B5's partials entry and B6 on every rank (a world
    of one on NCCL; two ranks on one card through gloo) against the
    single-device bundle_adjust with the kernels: poses 1e-3, costs rtol
    0.05 (tests/test_parallel.py's tolerances); every rank the same bits."""
    from gslam_tpu_torch.opt.ba import bundle_adjust
    from gslam_tpu_torch.parallel import launch

    fields = ba_case(6, 256, 8, seed=4, window=4)
    res = launch.spawn(ring_rank, world, device="cuda", backend=backend,
                       args=(fields, 6), timeout_s=300.0)
    out, st = bundle_adjust(to_problem(fields, dev), iters=6,
                            use_kernels=True)
    pose, costs, n_partials, n_cost = res[0]
    assert n_partials == 6 and n_cost == 7
    torch.testing.assert_close(pose, out.cam_pose.cpu(), rtol=0, atol=1e-3)
    torch.testing.assert_close(costs, st.cost.cpu(), rtol=0.05, atol=1e-8)
    for other in res[1:]:
        assert torch.equal(other[0], pose) and torch.equal(other[1], costs)


@pytest.mark.parametrize("O", [1, 8, 64])
@pytest.mark.parametrize("P", [1, 255, 256, 257, 1024, 65537])
def test_cost_kernel_sums_in_the_fixed_order(dev, P, O):
    """B6 on and beside its 256-point partials and past 256 partials,
    pad slots with the camera index -1 or C: within rtol 1e-5 of the
    plain version (pads set to camera 0 there), bit for bit the float32
    model of its order, one launch a call."""
    from gslam_tpu_torch.ops.cuda import schur
    from gslam_tpu_torch.opt import ba

    fields = ba_case(8, P, O, seed=P + O, window=4, pads=True)
    before = schur.cost_launches
    got = schur.ba_cost_kernel(to_problem(fields, dev), 0.01)
    plain = ba.ba_cost(to_problem(without_pad_indices(fields), dev), 0.01)
    assert schur.cost_launches == before + 1
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=0)
    want = cost_order(fields, 0.01)
    assert got.cpu().numpy().view(np.uint32) == want.view(np.uint32)


@pytest.mark.parametrize("P", [1024, 3000])
def test_cost_kernel_same_bits_over_calls_and_graph_replays(dev, P):
    """The same bits from two calls, from calls on other grids between
    them, and from two replays of a CUDA graph holding two calls: one
    cluster (P = 1024), and several, whose ticket starts every call
    from 0 (P = 3000)."""
    from gslam_tpu_torch.ops.cuda import schur

    prob = to_problem(ba_case(8, P, 8, seed=3, window=4, pads=True), dev)
    small = to_problem(ba_case(4, 1, 3, seed=4), dev)
    first = schur.ba_cost_kernel(prob)
    one = schur.ba_cost_kernel(small)
    again = schur.ba_cost_kernel(prob)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        schur.ba_cost_kernel(prob)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o1 = schur.ba_cost_kernel(prob)
        o2 = schur.ba_cost_kernel(prob)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays += [o1.clone(), o2.clone()]
    assert torch.equal(schur.ba_cost_kernel(small), one)
    for x in (again, *replays):
        assert torch.equal(x, first)


def test_cost_kernel_is_one_launch(dev):
    """torch.profiler sees one kernel, cost_kernel, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gslam_tpu_torch.ops.cuda import schur

    prob = to_problem(ba_case(8, 1024, 8, seed=5), dev)
    schur.ba_cost_kernel(prob)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            schur.ba_cost_kernel(prob)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    assert len(names) == 3 and all("cost_kernel" in n for n in names)


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


def test_vi_bundle_adjust_kernels_follow_plain_lm(dev):
    """The joint VI LM through B5 / B6 against the plain LM on one window
    (tests/test_vi.py's, C = 6, 10 iterations): B5 is not bit for bit
    (Hpp^-1 to test_pallas.py's tolerances), so the costs agree to rtol
    1e-3 and the poses to 1e-4 (test_pallas.py's VI tolerances), the
    velocities, biases and gravity to 1e-4 too.  B5 launches once per
    iteration and B6 once per cost."""
    from gslam_tpu_torch.ops.cuda import schur
    from gslam_tpu_torch.opt.vi import vi_bundle_adjust

    prob, _, _ = vi_case(device=dev)
    before = (schur.schur_launches, schur.cost_launches)
    out_k, c_k = vi_bundle_adjust(prob, iters=10, use_kernels=True)
    torch.cuda.synchronize()
    assert (schur.schur_launches - before[0],
            schur.cost_launches - before[1]) == (10, 11)
    out_p, c_p = vi_bundle_adjust(prob, iters=10)
    torch.testing.assert_close(c_k, c_p, rtol=1e-3, atol=0)
    for name in ("vel", "bias_g", "bias_a", "gravity_w"):
        torch.testing.assert_close(getattr(out_k, name), getattr(out_p, name),
                                   rtol=0, atol=1e-4)
    torch.testing.assert_close(out_k.vision.cam_pose, out_p.vision.cam_pose,
                               rtol=0, atol=1e-4)
    assert c_k[-1] < 0.1 * c_k[0]


def test_vi_bundle_adjust_kernels_refine_gravity(dev):
    """The gravity-refinement case of tests/test_vi.py (gravity 5 degrees
    off, the direction free) through B5 / B6: the reference's assertions
    hold (|g| = 9.81, under 2 degrees from the truth, the cost down).
    Not held against the plain LM: there a 1e-6 relative change of the
    observations alone moves the plain LM's poses by 6e-5 on the CPU, so
    B5's Hpp^-1 error (about 1e-3 relative) is beyond a 1e-4 pose
    tolerance."""
    from gslam_tpu_torch.ops.cuda import schur
    from gslam_tpu_torch.opt.vi import vi_bundle_adjust

    prob, _, _ = vi_case(device=dev, pose_noise=0.01, vel_noise=0.1,
                         tilt_deg=5.0)
    before = (schur.schur_launches, schur.cost_launches)
    out, c = vi_bundle_adjust(prob, iters=12, use_kernels=True,
                              refine_gravity=True)
    assert (schur.schur_launches - before[0],
            schur.cost_launches - before[1]) == (12, 13)
    g = out.gravity_w.cpu().numpy().astype(np.float64)
    assert abs(np.linalg.norm(g) - 9.81) < 1e-3
    cos = float(g @ [0.0, 0.0, -9.81]) / (9.81 * 9.81)
    assert np.degrees(np.arccos(min(cos, 1.0))) < 2.0
    assert torch.isfinite(c).all() and c[-1] < 1e-3 * c[0]


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


def check_descent(vocab_k, dev, k, L, N):
    """B7 on a random tree with ties against its plain version, word for
    word, and the same words again."""
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


# (k, L, N): trees whose top the kernel holds whole, in part or not at all
# (at most GSLAM_VOCAB_TOP_ROWS = 64 rows below the root, whole levels):
# all of k = 3, L = 3 (39 rows), k = 6, L = 2 (42) and k = 64, L = 1 (64,
# the cap); levels 1-5 of k = 2, L = 7 (62) and of k = 2, L = 6; levels
# 1-2 of k = 4, L = 3 (20); level 1 of k = 8, L = 4, k = 10, L = 2 and
# L = 6, k = 20 and k = 40 at L = 2; none of k = 65 and k = 200 at L = 1
VOCAB_CASES = [(3, 3, 173), (6, 2, 384), (8, 4, 513), (10, 2, 1),
               (40, 2, 257), (6, 2, 512), (10, 6, 384), (2, 7, 65),
               (200, 1, 100), (20, 2, 300), (64, 1, 64), (2, 6, 130),
               (4, 3, 77), (65, 1, 33)]


@pytest.mark.parametrize("k,L,N", VOCAB_CASES)
def test_vocab_kernel_equals_plain(dev, k, L, N):
    from gslam_tpu_torch.ops.cuda import vocab as vocab_k

    check_descent(vocab_k, dev, k, L, N)


@pytest.fixture(params=[(1, 64), (2, 64), (8, 64), (16, 64), (32, 64),
                        (4, 0), (4, 32), (4, 128)],
                ids=lambda v: f"dpb{v[0]}-rows{v[1]}")
def vocab_variant(dev, request, monkeypatch):
    """The B7 wrapper on a build with another count of descriptors per
    block or of table rows held (every variant scripts/tune_kernels.py
    b7 tries, and more)."""
    from gslam_tpu_torch.ops.cuda import vocab as vocab_k

    dpb, rows = request.param
    monkeypatch.setattr(vocab_k, "_lib", functools.partial(
        vocab_k._lib, (f"-DGSLAM_VOCAB_DPB={dpb}",
                       f"-DGSLAM_VOCAB_TOP_ROWS={rows}")))
    return vocab_k


@pytest.mark.parametrize("k,L,N", [
    (6, 2, 384), (8, 4, 513), (10, 2, 1), (40, 2, 257), (3, 3, 173),
    (2, 7, 65), (200, 1, 100)])
def test_vocab_kernel_variants_equal_plain(vocab_variant, dev, k, L, N):
    check_descent(vocab_variant, dev, k, L, N)


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
    shifted = torch.zeros(7 * 8 + 1, dtype=torch.int32, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        vocab_k.transform_words_kernel(nodes, shifted.view(7, 8), v, 4, 2)


# ---------------------------------------------------------------------------
# lens models and remaps: plain PyTorch on the card (no kernel of their
# own), held to the same call on the CPU at a few float32 ulps


@pytest.mark.parametrize("model", list(LENS_ARGS))
def test_lens_model_on_the_card_matches_the_cpu(dev, model):
    cam = lens_camera(model)
    p = lens_points(cam, seed=3)
    uv_c, ok_c = cam.project(p)
    uv_d, ok_d = cam.project(p.to(dev))
    grid = torch.from_numpy(pixel_grid())
    r_c = cam.unproject(grid)
    r_d = cam.unproject(grid.to(dev)).cpu()
    fin = torch.isfinite(uv_c).all(-1)
    assert float((uv_d.cpu() - uv_c)[fin].abs().max()) <= LENS_PX_TOL
    assert len(border_only(ok_d.cpu().numpy(), ok_c.numpy(), uv_c.numpy(),
                           640, 480, LENS_PX_TOL)) == 0
    assert torch.isfinite(r_d).all()
    assert float((r_d - r_c).abs().max()) <= LENS_RAY_TOL


@pytest.mark.parametrize("shape", [(480, 640), (97, 131)])
def test_remap_on_the_card_matches_the_cpu(dev, shape):
    H, W = shape
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.random((H, W), dtype=np.float32))
    m = torch.from_numpy(rng.uniform(-3, max(H, W) + 3, (H, W, 2))
                         .astype(np.float32))
    v = torch.from_numpy(rng.random((H, W)) > 0.1)
    ref = _remap(img, m, v)
    got = _remap(img.to(dev), m.to(dev), v.to(dev)).cpu()
    assert float((got - ref).abs().max()) <= REMAP_TOL
    und = Undistorter(Camera.opencv(*FR1_ARGS))
    img = torch.from_numpy(rng.random((480, 640), dtype=np.float32))
    ref = und.undistort(img)
    got = und.undistort(img.to(dev))
    assert got.device.type == "cuda"
    assert float((got.cpu() - ref).abs().max()) <= REMAP_TOL


def test_stereo_rectifier_on_the_card_matches_the_cpu(dev):
    R10, c1, T10 = rotated_rig()
    cam = Camera.opencv(640, 480, 457.0, 457.0, 320.0, 240.0, -0.25, 0.08)
    rec = StereoRectifier(cam, cam, T10)
    rng = np.random.default_rng(6)
    pair = [torch.from_numpy(rng.random((480, 640), dtype=np.float32))
            for _ in range(2)]
    ref = rec.rectify(*pair)
    got = rec.rectify(*[t.to(dev) for t in pair])
    for g, r in zip(got, ref):
        assert float((g.cpu() - r).abs().max()) <= REMAP_TOL


# -- the other SLAM systems on the card: one short run each ---------------

def small_frames(n, **over):
    """The first ``n`` frames of a synthetic sequence (12 frames of the
    192 x 144 line motion unless ``over`` says otherwise)."""
    from gslam_tpu_torch.datasets.synthetic import SyntheticDataset

    ds = SyntheticDataset(**{**dict(n_frames=12, n_points=300, width=192,
                                    height=144, motion="line", depth=True),
                             **over})
    ds.open("synth://")
    return ds.camera, [ds.grab_frame() for _ in range(n)]


def ate(system, frames):
    from gslam_tpu_torch.eval.trajectory import evaluate_trajectory

    t = np.asarray([fr.timestamp for fr in frames])
    gt = np.stack([fr.gt_pose[:3] for fr in frames])
    return evaluate_trajectory(t, system.positions(), t, gt,
                               with_scale=False).ate_rmse


def test_matcher_kernel_on_512_keypoints_of_two_frames(dev):
    """B3 at the odometry's and SfM's shape: two VGA frames' 512
    keypoints each, exactly its plain version."""
    cam, frames = small_frames(2, width=640, height=480, n_points=1200,
                               texture=True)
    f0, f1 = (frontend.extract_features(torch.as_tensor(fr.image,
                                                        device=dev),
                                        max_kps=512, threshold=0.08)
              for fr in frames)
    assert f0.desc.shape == f1.desc.shape == (512, 8)
    got = matcher.hamming_top2_kernel(f0.desc, f0.valid, f1.desc, f1.valid)
    ref = matching.hamming_top2(f0.desc, f0.valid, f1.desc, f1.valid)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_odometry_on_the_card(dev):
    from gslam_tpu_torch.models.odometry import FrameToFrameOdometry

    cam, frames = small_frames(6)
    runs = {}
    for uk in (True, False):
        before = (fastnms.launches, brief.launches, matcher.launches)
        odom = FrameToFrameOdometry(cam, max_kps=192, fast_threshold=0.1,
                                    use_kernels=uk, device=dev)
        for fr in frames:
            odom.track(fr)
        after = (fastnms.launches, brief.launches, matcher.launches)
        runs[uk] = (odom, [a - b for a, b in zip(after, before)])
    assert runs[True][1] == [6, 6, 5] and runs[False][1] == [0, 0, 0]
    k, p = runs[True][0], runs[False][0]
    assert [s["n_matches"] for s in k.stats] == \
        [s["n_matches"] for s in p.stats]
    assert min(s["n_inliers"] for s in k.stats[1:]) > 50
    torch.testing.assert_close(torch.stack(k.trajectory),
                               torch.stack(p.trajectory), atol=1e-5, rtol=0)


def test_stereo_slam_on_the_card(dev):
    from gslam_tpu_torch.models.keyframe_slam import SLAMConfig
    from gslam_tpu_torch.models.stereo import StereoSLAM

    cam, frames = small_frames(6, depth=False, stereo=True, n_points=400)
    before = (fastnms.launches, orient.launches, brief.launches)
    slam = StereoSLAM(cam, SLAMConfig(max_kps=192, fast_threshold=0.1,
                                      kf_min_gap=2, kf_max_gap=3),
                      device=dev)
    for fr in frames:
        slam.track(fr)
    # two images a frame, and the warm-up of each extraction graph this
    # run captured (a graph of the process replays without one): at most
    # one capture a span, the left image's and the right's
    captures = extract_captures(slam)
    assert captures <= 2
    want = 2 * len(frames) + captures
    assert (fastnms.launches - before[0], orient.launches - before[1],
            brief.launches - before[2]) == (want, want, want)
    assert slam._n_frames_host >= 2
    assert int(slam.arena.point_valid.sum()) > 50
    assert ate(slam, frames) < 0.12


def test_direct_odometry_on_the_card_matches_the_cpu(dev):
    from gslam_tpu_torch.models.direct import DirectConfig, DirectOdometry

    cam, frames = small_frames(5)
    out = []
    for d in (dev, "cpu"):
        slam = DirectOdometry(cam, DirectConfig(n_points=512), device=d)
        for fr in frames:
            slam.track(fr)
        out.append(torch.stack(slam.trajectory).cpu())
    torch.testing.assert_close(out[0], out[1], atol=1e-4, rtol=0)


def test_sfm_on_the_card(dev):
    from gslam_tpu_torch.models.sfm import GlobalSfM
    from gslam_tpu_torch.ops.cuda import schur

    cam, frames = small_frames(5, n_frames=24, width=256, height=192,
                               n_points=800, motion="orbit", depth=False)
    before = (matcher.launches, schur.schur_launches, schur.cost_launches)
    sfm = GlobalSfM(cam, max_kps=384, fast_threshold=0.08,
                    min_pair_inliers=15, ba_iters=2, device=dev)
    for fr in frames:
        sfm.track(fr)
    res = sfm.finalize()
    after = (matcher.launches, schur.schur_launches, schur.cost_launches)
    assert after[0] - before[0] == 10              # one B3 a pair
    assert after[1] - before[1] == 6 and after[2] - before[2] == 9
    assert res["n_edges"] >= 4 and np.isfinite(res["centers"]).all()
