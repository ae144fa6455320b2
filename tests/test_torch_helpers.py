"""Small helpers of modules already ported, against the JAX package's
(ROADMAP Queue A item 18, the part this slice needs or touches):
``se3_identity``, ``se3_t``, ``se3_q``, ``se3_to_matrix``,
``matrix_to_se3`` and ``quat_identity`` (tests/test_geometry.py:128-132),
``cauchy_weight`` and ``tukey_weight``, ``num_hypotheses``,
``match_frames``, ``TicToc``, the logging facade, and the package
re-exports of ``gslam_tpu/{core,estimation,map,ops,opt,models}``.
Bit for bit except ``se3_to_matrix`` and ``matrix_to_se3`` (1e-6,
measured 4.8e-7 and 6e-8: jitted, XLA fuses the quaternion conversions'
products into FMAs) and the matrix round trip (1e-5, as in the JAX
package's own test).
"""

import ast
import importlib
import logging
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslam_tpu.core import se3 as jse3
from gslam_tpu.core import so3 as jso3
from gslam_tpu.estimation.ransac import num_hypotheses as j_num_hypotheses
from gslam_tpu.ops.frontend import extract_features as j_extract
from gslam_tpu.ops.matching import match_frames as j_match_frames
from gslam_tpu.opt import robust as jrobust
from gslam_tpu.utils.timer import TicToc as JTicToc
from gslam_tpu_torch.core import se3, so3
from gslam_tpu_torch.estimation.ransac import num_hypotheses
from gslam_tpu_torch.ops.matching import match_frames
from gslam_tpu_torch.opt import robust
from gslam_tpu_torch.utils.logging import check, get_logger
from gslam_tpu_torch.utils.timer import TicToc
from tests.test_torch_slam import datasets, port_features

REPO = Path(__file__).resolve().parents[1]
# re-exported by the JAX package, not ported yet: none is left (item 18's
# fits and cull are tests/test_torch_alignment.py's)
NOT_YET = set()


def rand_se3(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.normal(size=(n, 3)), q], 1).astype(np.float32)


@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_identities_bit_for_bit(shape):
    np.testing.assert_array_equal(se3.se3_identity(shape).numpy(),
                                  np.asarray(jse3.se3_identity(shape)))
    np.testing.assert_array_equal(so3.quat_identity(shape).numpy(),
                                  np.asarray(jso3.quat_identity(shape)))
    assert se3.se3_identity(shape, dtype=torch.float64).dtype == \
        torch.float64


def test_se3_accessors_and_matrices():
    T = rand_se3(np.random.default_rng(0), 50)
    for fn in ("se3_t", "se3_q"):
        np.testing.assert_array_equal(
            getattr(se3, fn)(torch.as_tensor(T)).numpy(),
            np.asarray(getattr(jse3, fn)(jnp.asarray(T))), fn)
    M = np.array(jse3.se3_to_matrix(jnp.asarray(T)))
    np.testing.assert_allclose(se3.se3_to_matrix(torch.as_tensor(T)).numpy(),
                               M, atol=1e-6)
    np.testing.assert_allclose(
        se3.matrix_to_se3(torch.as_tensor(M)).numpy(),
        np.asarray(jse3.matrix_to_se3(jnp.asarray(M))), atol=1e-6)
    # tests/test_geometry.py:128-132: the round trip through 4x4
    T2 = se3.matrix_to_se3(se3.se3_to_matrix(torch.as_tensor(T)))
    np.testing.assert_allclose(se3.se3_to_matrix(T2).numpy(), M, atol=1e-5)


@pytest.mark.parametrize("c", [0.5, 2.0])
def test_robust_weights_bit_for_bit(c):
    e = np.linspace(-4.0, 4.0, 161).astype(np.float32)
    for fn in ("cauchy_weight", "tukey_weight", "huber_weight"):
        np.testing.assert_array_equal(
            getattr(robust, fn)(torch.as_tensor(e), c).numpy(),
            np.asarray(getattr(jrobust, fn)(jnp.asarray(e), c)), fn)


def outcome(fn, *args):
    try:
        return fn(*args)
    except ZeroDivisionError:
        return "ZeroDivisionError"


def test_num_hypotheses_equal():
    """Equal counts; where the inlier ratio is so small that 1 - w
    rounds to 1, both raise ZeroDivisionError (log(1) = 0)."""
    for min_set in (1, 3, 4, 5, 8):
        for ratio in (0.0, 0.1, 0.25, 0.4, 0.7, 1.0):
            for conf in (0.9, 0.99, 0.999, 1.0):
                args = (min_set, ratio, conf)
                assert outcome(num_hypotheses, *args) == \
                    outcome(j_num_hypotheses, *args)
    assert num_hypotheses(4, 0.05, cap=256) == 256


def test_match_frames_equal():
    dj, _ = datasets(n_frames=2)
    a, b = (j_extract(jnp.asarray(fr.image), max_kps=192, threshold=0.1)
            for fr in dj)
    mj = j_match_frames(a, b, ratio=0.85)
    mt = match_frames(port_features(a), port_features(b), ratio=0.85)
    np.testing.assert_array_equal(mt.idx.numpy(), np.asarray(mj.idx))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    assert int(mt.count) == int(mj.count) > 50


def test_tictoc():
    for cls in (TicToc, JTicToc):
        tt = cls()
        time.sleep(0.01)
        first = tt.toc()
        assert first >= 0.01
        tt.tic()
        assert 0.0 <= tt.toc() < first


def test_logging_facade():
    log = get_logger("gslam_tpu_torch.models.sfm")
    root = logging.getLogger("gslam_tpu_torch")
    assert log.parent is root or log.name.startswith(root.name)
    assert root.handlers and not root.propagate
    assert get_logger() is root
    check(True)
    with pytest.raises(AssertionError, match="CHECK failed: why"):
        check(False, "why")


def reexports(package: str):
    """Names the JAX package's ``__init__`` imports from its modules."""
    path = REPO / "gslam_tpu" / package / "__init__.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "gslam_tpu."):
            names |= {a.asname or a.name for a in node.names}
    return names


@pytest.mark.parametrize("package", ["core", "estimation", "map", "ops",
                                     "opt", "models"])
def test_package_reexports(package):
    names = reexports(package)
    assert names
    mod = importlib.import_module(f"gslam_tpu_torch.{package}")
    missing = sorted(n for n in names - NOT_YET if not hasattr(mod, n))
    assert not missing
