"""The port stands alone: importing every module of ``gslam_tpu_torch``
(the CLI, ``bench``, ``graft_entry`` and ``__main__`` among them) in a
fresh process loads neither JAX nor the JAX package, and loads no CUDA
kernel (the kernels build on first launch); and the CLI without a card
and without ``-cpu true`` fails instead of running on the CPU.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import gslam_tpu_torch
names = ["gslam_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(gslam_tpu_torch.__path__,
                                          "gslam_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from gslam_tpu_torch.ops.cuda import build
print(json.dumps({
    "modules": names,
    "reference": sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "gslam_tpu")),
    "kernels_loaded": len(build._LIBS)}))
"""


def run_python(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_the_reference():
    out = run_python("-c", IMPORT_ALL)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("gslam_tpu_torch.__main__", "gslam_tpu_torch.app.cli",
                 "gslam_tpu_torch.app.config", "gslam_tpu_torch.app.messenger",
                 "gslam_tpu_torch.app.webviz", "gslam_tpu_torch.bench",
                 "gslam_tpu_torch.graft_entry",
                 "gslam_tpu_torch.models.pipeline",
                 "gslam_tpu_torch.eval.report",
                 "gslam_tpu_torch.utils.metrics"):
        assert name in got["modules"], name
    assert got["reference"] == []
    assert got["kernels_loaded"] == 0


def test_cli_without_a_card_raises_instead_of_running_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    path = tmp_path / "seq.synth"
    path.write_text(json.dumps({"n_frames": 3, "n_points": 200,
                                "width": 160, "height": 120}))
    for app in ("play", "eval", "viz"):
        out = run_python("-m", "gslam_tpu_torch", app, "-dataset", str(path))
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr
    out = run_python("-m", "gslam_tpu_torch", "play", "-dataset", str(path),
                     "-cpu", "true", "-slam", "keyframe", "-slam.max_kps",
                     "128")
    assert out.returncode == 0, out.stderr
    out = run_python("-m", "gslam_tpu_torch")
    assert out.returncode == 1 and "apps:" in out.stdout
