"""The port's projection-gated matcher (gslam_tpu_torch.ops.matching.
match_descriptors_gated, and the B4 wrapper match_hamming_gated of
gslam_tpu_torch.ops.cuda.matcher, which takes its plain version on CPU
tensors) against the JAX package's match_descriptors_gated and its
Pallas kernel match_hamming_gated_pallas in interpret mode.

Tolerance: none.  Hamming distances are integers and the pixel gate is
compared in float32 in the same order, so match indices, validity and
distances are equal; ties go to the lowest keypoint index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.ops.matching import match_descriptors_gated as j_gated
from gslam_tpu.ops.pallas.matcher import match_hamming_gated_pallas
from gslam_tpu_torch.ops import matching as tm
from gslam_tpu_torch.ops.cuda import matcher as tk

torch.set_num_threads(2)


def rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


def make_case(rng, N, M, gate, extent=100.0):
    """Map rows and keypoints with near copies inside the gate, exact
    duplicates (ties), and pairs exactly on the gate radius."""
    a = rand_desc(rng, N)
    b = rand_desc(rng, M)
    k = min(N, M) // 2
    b[:k] = a[:k]
    b[:k, 0] ^= 0b111                      # 3-bit noise copies
    if M > 4 and N > 4:
        b[k + 1] = b[k]                    # a tied pair of keypoints
        a[N - 1] = b[k]
    va = rng.random(N) < 0.9
    vb = rng.random(M) < 0.9
    uv_a = rng.uniform(0, extent, (N, 2)).astype(np.float32)
    uv_b = rng.uniform(0, extent, (M, 2)).astype(np.float32)
    uv_b[:k] = uv_a[:k] + rng.uniform(-0.5, 0.5, (k, 2)).astype(
        np.float32) * gate
    if M > 4 and N > 4:
        uv_b[k] = uv_b[k + 1] = uv_a[N - 1]
        uv_b[2] = uv_a[2] + np.asarray([gate, 0.0], np.float32)  # on the gate
    return a, va, b, vb, uv_a, uv_b


def port_args(a, va, b, vb, uv_a, uv_b):
    return (torch.tensor(a.view(np.int32)), torch.tensor(va),
            torch.tensor(b.view(np.int32)), torch.tensor(vb),
            torch.tensor(uv_a), torch.tensor(uv_b))


@pytest.mark.parametrize("N,M,gate,ratio", [
    (96, 64, 12.0, 0.9), (2048, 512, 40.0, 0.85), (37, 5, 30.0, 0.85),
    (20, 2, 40.0, 0.9)])
def test_gated_matches_reference(N, M, gate, ratio):
    rng = np.random.default_rng(N + M)
    case = make_case(rng, N, M, gate)
    gold = j_gated(*map(jnp.asarray, case), gate, max_dist=64.0,
                   ratio=ratio)
    before = tk.gated_launches
    for fn in (tm.match_descriptors_gated, tk.match_hamming_gated):
        out = fn(*port_args(*case), gate, max_dist=64.0, ratio=ratio)
        np.testing.assert_array_equal(out.idx.numpy(), np.asarray(gold.idx))
        np.testing.assert_array_equal(out.valid.numpy(),
                                      np.asarray(gold.valid))
        np.testing.assert_array_equal(out.dist.numpy(),
                                      np.asarray(gold.dist))
        assert int(out.count) == int(gold.count)
    assert tk.gated_launches == before     # CPU tensors: plain version
    if M >= 64:
        assert int(gold.count) > 10


def test_gated_matches_pallas_interpret():
    """The TPU kernel in interpret mode, on tests/test_pallas.py's
    case."""
    rng = np.random.default_rng(0)
    case = make_case(rng, 96, 64, 12.0)
    out_p = match_hamming_gated_pallas(*map(jnp.asarray, case), 12.0,
                                       max_dist=64.0, ratio=0.9,
                                       interpret=True)
    out_t = tm.match_descriptors_gated(*port_args(*case), 12.0,
                                       max_dist=64.0, ratio=0.9)
    np.testing.assert_array_equal(out_t.idx.numpy(), np.asarray(out_p.idx))
    np.testing.assert_array_equal(out_t.valid.numpy(),
                                  np.asarray(out_p.valid))


def test_top2_against_brute_force():
    """best / second / idx of the plain version against a numpy loop:
    the lowest column of equal minima, second = best on a tie, masked
    pairs at 257, a fully masked row at column 0."""
    rng = np.random.default_rng(9)
    a, va, b, vb, uv_a, uv_b = make_case(rng, 50, 30, 25.0)
    va[3] = False
    best, second, idx = tm.hamming_top2_gated(
        *port_args(a, va, b, vb, uv_a, uv_b), tm.gate_squared(25.0))
    bits = np.unpackbits(a.view(np.uint8), axis=1)
    bbits = np.unpackbits(b.view(np.uint8), axis=1)
    for i in range(len(a)):
        d = (bits[i][None] != bbits).sum(1).astype(np.float32)
        dx = uv_a[i, 0] - uv_b[:, 0]
        dy = uv_a[i, 1] - uv_b[:, 1]
        ok = va[i] & vb & (dx * dx + dy * dy <= np.float32(625.0))
        d = np.where(ok, d, 257.0)
        j = int(np.argmin(d))
        assert int(idx[i]) == j and float(best[i]) == d[j]
        assert float(second[i]) == np.delete(d, j).min()
    assert float(best[3]) == 257.0 and int(idx[3]) == 0


def test_gate_is_the_float32_square():
    assert tm.gate_squared(40.0) == 1600.0
    g = np.float32(12.3)
    assert tm.gate_squared(12.3) == float(g * g)
