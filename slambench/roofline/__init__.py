"""Kernels' least times from their bytes and operations.

Each ``roofline/<kernel>.py`` names the kernel's device functions as the
profiler shows them (``KERNELS``; the last one runs once a launch) and
gives ``work(run)``, the bytes and float operations of its launches on
what the run handed the program, a (bytes, operations) pair for each
launch or sample it counts.  The peaks are the data sheet's
(``peaks.json``).  A kernel's share of its roofline is the least time of
a launch over its device time a launch in the traced window.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Optional, Tuple

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def least_s(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the float32 rate."""
    tb = n_bytes / PEAKS["hbm_bytes_per_s"]
    to = n_ops / PEAKS["fp32_ops_per_s"]
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel(name: str):
    return importlib.import_module(f"slambench.roofline.{name}")


def device_s_per_launch(run, kernels) -> Optional[float]:
    """Device seconds a launch of the kernel whose device functions are
    ``kernels`` (the last runs once a launch), from the traced window."""
    trace = run.trace
    if trace is None:
        return None
    total, launches = 0.0, 0
    for name, (secs, count) in trace.kernels.items():
        if any(k in name for k in kernels):
            total += secs
            if kernels[-1] in name:
                launches += count
    return total / launches if launches else None


def share_pct(run, name: str) -> Optional[float]:
    """The kernel ``name``'s share of its roofline in percent, or None
    where the traced window launched it nowhere."""
    mod = kernel(name)
    dev_s = device_s_per_launch(run, mod.KERNELS)
    if not dev_s:
        return None
    work = mod.work(run)
    if not work:
        return None
    bounds = [least_s(*w) for w in work]
    least = sum(t for t, _ in bounds) / len(bounds)
    by = sorted({b for _, b in bounds})
    run.notes.append(f"{name}: least {least * 1e3:.6f} ms a launch (by "
                     f"{' and '.join(by)}), device {dev_s * 1e3:.6f} ms, "
                     f"against {PEAKS['card']} peaks; card {run.card}")
    return 100.0 * least / dev_s
