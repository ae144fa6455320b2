"""The summation order of the B6 cost kernel (csrc/schur.cu), modelled in
float32 numpy by ``chip_smoke.cost_order``, against the port's plain
``ba_cost`` and the JAX package's ``gslam_tpu.opt.ba.ba_cost`` at rtol
1e-5 (the kernel's tolerance against its plain version).  The point
counts sit on and beside the kernel's 256-point partials (1, 255, 256,
257, 1024) and beyond 256 partials (65537, where the last fold takes
two partials in one entry), so every term is shown to be summed once
across block and partial edges.  On the card the kernel is held to the
same model bit for bit (tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ba_case, cost_order, tree_sum, without_pad_indices
from gslam_tpu.opt import ba as jba
from gslam_tpu_torch.opt import ba as tba

HD = 0.01


@pytest.mark.parametrize("P", [1, 255, 256, 257, 1024, 65537])
@pytest.mark.parametrize("C,O,pads", [(8, 8, False), (5, 3, True)])
def test_cost_order_sums_every_term_once(P, C, O, pads):
    fields = ba_case(C, P, O, seed=P + O, window=4, pads=pads)
    model = cost_order(fields, HD)
    assert model.dtype == np.float32 and np.isfinite(model) and model > 0
    plain = without_pad_indices(fields)
    port = tba.ba_cost(tba.BundleProblem(*(torch.as_tensor(x)
                                           for x in plain)), HD)
    ref = jba.ba_cost(jba.BundleProblem(*(jnp.asarray(x) for x in plain)),
                      HD)
    np.testing.assert_allclose(model, port.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(model, np.asarray(ref), rtol=1e-5, atol=0)


def test_cost_order_is_the_kernels_tree():
    """The tree pairs entry t with t + h for h = 128, ..., 1: exact on
    small integers, and on 2^24 with two ones at entries 64 and 192 it
    gives 2^24 + 2 (the ones meet first), where a sum in index order
    would round each one away."""
    rows = np.arange(512, dtype=np.float32).reshape(2, 256)
    np.testing.assert_array_equal(tree_sum(rows),
                                  [sum(range(256)), sum(range(256, 512))])
    row = np.zeros((1, 256), np.float32)
    row[0, 0], row[0, 64], row[0, 192] = 2.0 ** 24, 1, 1
    assert tree_sum(row)[0] == np.float32(2 ** 24 + 2)
    assert (row[0, 0] + row[0, 64]) + row[0, 192] == np.float32(2 ** 24)
