"""The port's slice as a whole: gslam_tpu_torch.models.graft.track_forward
against gslam_tpu.models.graft.track_forward (use_pallas=False) on the
same frame and the same local-map slab, carried across by
gslam_tpu_torch.convert, with the reference's RANSAC draws fed to the
port.  Tolerances: the feature count exactly, the inlier count to +/-1
and the pose to 1e-4 (float32; see test_torch_pnp.py).

Also, in a fresh interpreter: the port (its distributed layer,
``gslam_tpu_torch.parallel``, among it) and chip_smoke.py's imports load
neither JAX nor the JAX package, and the entry points raise when called
without ``device=`` on a machine without a card.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from gslam_tpu.models import graft as jg
from gslam_tpu_torch import convert
from gslam_tpu_torch.models import graft as tg

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("H,W,M,K,B", [(120, 160, 256, 128, 64),
                                       (96, 128, 192, 64, 32)])
def test_track_forward_matches_reference(H, W, M, K, B):
    img, cam, xyz, desc, valid, key = jg.example_inputs(H=H, W=W, M=M,
                                                        max_kps=K)
    T_j, n_j, nf_j = jg.track_forward(img, cam, xyz, desc, valid, key,
                                      max_kps=K, ransac_b=B,
                                      use_pallas=False)
    slab = convert.map_slab_from_numpy(np.asarray(xyz), np.asarray(desc),
                                       np.asarray(valid), device="cpu")
    u = torch.tensor(np.asarray(jax.random.uniform(key, (B, 4))))
    T_t, n_t, nf_t = tg.track_forward(
        torch.tensor(np.asarray(img)),
        convert.camera_from_numpy(np.asarray(cam), device="cpu"), *slab,
        uniforms=u, max_kps=K, ransac_b=B, device="cpu")
    assert int(nf_t) == int(nf_j)
    assert abs(int(n_t) - int(n_j)) <= 1
    assert int(n_j) >= int(np.asarray(valid)[:K].sum()) // 2
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    np.testing.assert_allclose(T_t.numpy(), [0, 0, 0, 1, 0, 0, 0],
                               atol=1e-3)


def test_track_forward_on_own_example_with_generator():
    """The port end to end on its own example inputs, sampling from a
    torch.Generator: recovers the identity pose; the kernel route
    (plain versions on CPU tensors) gives the same result."""
    args = tg.example_inputs(96, 128, 192, 64, device="cpu")
    out = []
    for use_kernels in (True, False):
        gen = torch.Generator().manual_seed(3)
        out.append(tg.track_forward(*args[:5], generator=gen, max_kps=64,
                                    ransac_b=32, use_kernels=use_kernels,
                                    device="cpu"))
    (T, n, nf), (T2, n2, nf2) = out
    assert torch.equal(T, T2) and int(n) == int(n2) and int(nf) == int(nf2)
    np.testing.assert_allclose(T.numpy(), [0, 0, 0, 1, 0, 0, 0], atol=1e-3)
    assert int(n) >= int(args[4][:64].sum()) // 2


def test_features_and_matches_to_numpy():
    img = tg.example_image(96, 128)[0]
    from gslam_tpu_torch.ops.frontend import extract_features
    from gslam_tpu_torch.ops.matching import match_descriptors

    f = extract_features(torch.as_tensor(img), max_kps=32)
    d = convert.features_to_numpy(f)
    assert d["desc"].dtype == np.uint32 and d["desc"].shape == (32, 8)
    assert d["uv"].shape == (32, 2) and int(d["count"]) == int(f.count)
    m = convert.matches_to_numpy(match_descriptors(f.desc, f.valid, f.desc,
                                                   f.valid))
    # self-matches: distance 0 where the ratio test keeps a match (the
    # example's equal squares give equal descriptors, which it drops)
    ok = m["valid"]
    assert ok.sum() > 0 and (m["dist"][ok] == 0).all()
    np.testing.assert_array_equal(m["idx"][ok], np.flatnonzero(ok))
    with pytest.raises(ValueError):
        convert.map_slab_from_numpy(np.zeros((4, 3)), np.zeros((5, 8)),
                                    np.ones(4, bool), device="cpu")


CHECK = textwrap.dedent("""
    import importlib, pkgutil, sys
    import gslam_tpu_torch
    for m in pkgutil.walk_packages(gslam_tpu_torch.__path__,
                                   "gslam_tpu_torch."):
        importlib.import_module(m.name)
    import chip_smoke  # noqa: F401  (its imports; main() is not run)
    for m in ("parallel", "parallel.mesh", "parallel.launch",
              "parallel.dist_ba", "parallel.tracking"):
        assert "gslam_tpu_torch." + m in sys.modules, m
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "gslam_tpu" or m.startswith("gslam_tpu."))
    assert not bad, bad
    import torch
    from gslam_tpu_torch.models import graft
    if not torch.cuda.is_available():
        for call in (lambda: graft.example_inputs(32, 48, 16, 8),
                     lambda: graft.track_forward(*[torch.zeros(1)] * 5)):
            try:
                call()
            except RuntimeError as e:
                assert "cuda" in str(e), e
            else:
                raise AssertionError("an entry point ran without a card")
    print("OK", len(sys.modules))
""")


def test_port_imports_no_jax_and_needs_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", CHECK], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK")
