"""Hand-written CUDA kernels for Hopper (``sm_90a``), bound with ctypes.

Each wrapper module (``fastnms``, ``orient``, ``brief``, ``matcher``,
``schur``, ``vocab``) takes its plain PyTorch version for CPU tensors
and, for CUDA tensors, launches its kernel or raises; a module-level
counter per kernel (:data:`LAUNCH_COUNTERS`) counts its launches on the
card, which :func:`launch_counts` reads (:mod:`.graphs` keeps them true
for graphs).  Sources live in ``gslam_tpu_torch/csrc``; :mod:`.build`
compiles them on first use.  Importing these modules builds nothing.
"""

from __future__ import annotations

import importlib
from typing import Dict

# kernel -> (wrapper module, its launch counter)
LAUNCH_COUNTERS = {
    "fast_nms": ("fastnms", "launches"), "brief": ("brief", "launches"),
    "matcher": ("matcher", "launches"),
    "gated_matcher": ("matcher", "gated_launches"),
    "schur": ("schur", "schur_launches"),
    "ba_cost": ("schur", "cost_launches"),
    "schur_partials": ("schur", "partials_launches"),
    "bow_descent": ("vocab", "launches"),
    "orientation": ("orient", "launches")}


def _wrapper(kernel: str):
    mod, attr = LAUNCH_COUNTERS[kernel]
    return importlib.import_module(f"{__name__}.{mod}"), attr


def launch_counts() -> Dict[str, int]:
    """Each kernel's launch counter."""
    return {k: getattr(*_wrapper(k)) for k in LAUNCH_COUNTERS}


def add_launches(n: Dict[str, int]) -> None:
    """Add ``n[kernel]`` (negative to take back) to each kernel's
    counter."""
    for kernel, k in n.items():
        if k:
            mod, attr = _wrapper(kernel)
            setattr(mod, attr, getattr(mod, attr) + k)
