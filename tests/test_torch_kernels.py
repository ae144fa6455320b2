"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA card and ``nvcc`` and skips
without one; run them on a machine with a card by

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: this file imports neither JAX nor the JAX package,
so it runs where JAX is not installed).  Tolerances: FAST+NMS to 1e-5
(float32 arc sums in the same order; in practice equal), BRIEF bit for
bit and the matcher exactly (integer arithmetic), as the kernels'
headers state.  The CPU half of the contract (a CPU tensor takes the
plain version) is in the frontend and matching test files.
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("shape,arc,r", [
    ((120, 160), 9, 3), ((97, 131), 9, 3), ((480, 640), 9, 3),
    ((64, 70), 12, 1)])         # 2x2 squares: every circle pixel darker
def test_fast_nms_kernel_matches_plain(dev, shape, arc, r):
    rng = np.random.default_rng(1)
    img = blob_image(rng, *shape, n=shape[0] * shape[1] // 600, r=r)
    img += rng.uniform(0, 0.02, img.shape).astype(np.float32)
    t = torch.as_tensor(img, device=dev)
    before = fastnms.launches
    nms_k, raw_k = fastnms.fast_nms_raw(t, 0.06, arc)
    nms_p, raw_p = fastnms.fast_nms_plain(t, 0.06, arc)
    torch.cuda.synchronize()
    assert fastnms.launches == before + 1
    torch.testing.assert_close(raw_k, raw_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(nms_k, nms_p, atol=1e-5, rtol=0)
    assert torch.equal(nms_k > 0, nms_p > 0)
    assert (nms_k > 0).sum() > 0


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
                                 (333, 1000)])
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
