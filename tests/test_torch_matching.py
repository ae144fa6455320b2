"""Gold tests of the port's matcher (gslam_tpu_torch.ops.matching)
against gslam_tpu.ops.matching.match_descriptors (the jnp path the
Pallas matcher is held to).  Hamming distances are integer sums, so
every decision must be identical: idx, valid, dist and count, with ties
(duplicate rows and columns) broken by lowest index and invalid entries
masked, the mutual check on and off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.ops import matching as jm
from gslam_tpu_torch import convert
from gslam_tpu_torch.ops import matching as tm
from gslam_tpu_torch.ops.cuda import matcher

torch.set_num_threads(2)


def random_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


def case(seed, N, M):
    """Descriptor sets with near-duplicates, exact duplicates in rows
    and columns (ties), and invalid entries on both sides."""
    rng = np.random.default_rng(seed)
    b = random_desc(rng, M)
    a = random_desc(rng, N)
    src = rng.integers(0, M, N // 2)
    a[:N // 2] = b[src]
    flips = rng.integers(0, 256, (N // 2, 6))       # a few flipped bits
    for i, f in enumerate(flips[: N // 4]):
        for bit in f:
            a[i, bit // 32] ^= np.uint32(1 << (bit % 32))
    b[1] = b[0]                                     # tied columns
    b[5] = b[4]
    a[N - 1] = a[N - 2]                             # tied rows
    a[N - 3] = b[7]
    va = rng.uniform(size=N) > 0.15
    vb = rng.uniform(size=M) > 0.15
    vb[0] = vb[1] = vb[4] = vb[5] = True
    return a, va, b, vb


def test_unpack_and_hamming_match_reference():
    a, _, b, _ = case(0, 40, 30)
    ta = convert.desc_from_numpy(a, device="cpu")
    tb = convert.desc_from_numpy(b, device="cpu")
    np.testing.assert_array_equal(
        tm.unpack_descriptors(ta).numpy(),
        np.asarray(jm.unpack_descriptors(jnp.asarray(a)), np.float32))
    d_t = tm.hamming_matrix(ta, tb).numpy()
    np.testing.assert_array_equal(d_t, np.asarray(
        jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    # and against a popcount on the host
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    pop = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(d_t, pop.astype(np.float32))


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("seed,N,M", [(1, 256, 128), (2, 64, 200),
                                      (3, 3, 2)])
def test_match_descriptors_identical(seed, N, M, mutual):
    a, va, b, vb = case(seed, N, M) if N > 8 else (
        random_desc(np.random.default_rng(seed), N),
        np.ones(N, bool), random_desc(np.random.default_rng(seed + 9), M),
        np.ones(M, bool))
    m_j = jm.match_descriptors(jnp.asarray(a), jnp.asarray(va),
                               jnp.asarray(b), jnp.asarray(vb),
                               max_dist=100.0, mutual=mutual)
    ta = convert.desc_from_numpy(a, device="cpu")
    tb = convert.desc_from_numpy(b, device="cpu")
    m_t = tm.match_descriptors(ta, torch.as_tensor(va), tb,
                               torch.as_tensor(vb), max_dist=100.0,
                               mutual=mutual)
    got = convert.matches_to_numpy(m_t)
    np.testing.assert_array_equal(got["idx"], np.asarray(m_j.idx))
    np.testing.assert_array_equal(got["valid"], np.asarray(m_j.valid))
    np.testing.assert_array_equal(got["dist"], np.asarray(m_j.dist))
    assert int(got["count"]) == int(m_j.count)
    if N > 8:
        assert int(m_j.count) > 0


def test_top2_ties_and_masked_columns():
    a, va, b, vb = case(4, 32, 16)
    vb[9] = False
    va[:] = True
    ta = convert.desc_from_numpy(a, device="cpu")
    tb = convert.desc_from_numpy(b, device="cpu")
    best, second, idx, back = tm.hamming_top2(ta, torch.as_tensor(va), tb,
                                              torch.as_tensor(vb))
    D = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    D = np.where(va[:, None] & vb[None, :], D, 257.0)
    np.testing.assert_array_equal(idx.numpy(), D.argmin(1))    # first min
    np.testing.assert_array_equal(best.numpy(), D.min(1))
    srt = np.sort(D, 1)
    np.testing.assert_array_equal(second.numpy(), srt[:, 1])
    np.testing.assert_array_equal(back.numpy(), D.argmin(0))
    assert back[9] == 0                     # a masked column -> row 0


def test_kernel_wrapper_takes_plain_version_on_cpu():
    a, va, b, vb = case(5, 64, 48)
    args = (convert.desc_from_numpy(a, device="cpu"), torch.as_tensor(va),
            convert.desc_from_numpy(b, device="cpu"), torch.as_tensor(vb))
    n0 = matcher.launches
    for x, y in zip(matcher.hamming_top2_kernel(*args),
                    tm.hamming_top2(*args)):
        assert torch.equal(x, y)
    for x, y in zip(matcher.match_hamming(*args),
                    tm.match_descriptors(*args)):
        assert torch.equal(x, y)
    assert matcher.launches == n0


def test_desc_conversion_round_trips_bit_31():
    d = np.asarray([[2 ** 31, 2 ** 32 - 1, 0, 1, 5, 7, 2 ** 30, 3]],
                   np.uint32)
    t = convert.desc_from_numpy(d, device="cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(convert.desc_to_numpy(t), d)
