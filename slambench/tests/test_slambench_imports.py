"""The import guard: nothing the harness runs loads JAX or the JAX
package (top-level names compared whole: the port's name begins with
the JAX package's), and the reference loads nothing of the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

HARNESS = """
import importlib, sys
from pathlib import Path
import slambench.run as r, slambench.calibrate, slambench.trace
import slambench.scene, slambench.reference
for kind in ("metrics", "roofline"):
    for f in sorted(Path("slambench", kind).glob("*.py")):
        if kind == "metrics":
            r.reader(f.stem)
        else:
            importlib.import_module(f"slambench.roofline.{f.stem}")
import gslam_tpu_torch.models, gslam_tpu_torch.models.stereo
import gslam_tpu_torch.ops.cuda.build, gslam_tpu_torch.ops.cuda.schur
import gslam_tpu_torch.utils.timer, gslam_tpu_torch.datasets.base
print(" ".join(r.banned_modules()))
"""


def probe(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_the_harness_loads_no_jax():
    assert probe(HARNESS) == ""


def test_the_reference_loads_nothing_of_the_program():
    tops = probe("import sys, slambench.reference\n"
                 "print(' '.join(sorted({m.split('.')[0] "
                 "for m in sys.modules})))").split()
    assert not {"jax", "jaxlib", "flax", "gslam_tpu",
                "gslam_tpu_torch"} & set(tops)
