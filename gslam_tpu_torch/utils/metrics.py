"""Run metrics: per-frame JSON-line rows and memory accounting.

Counterpart of ``gslam_tpu/utils/metrics.py``.  The device memory is the
CUDA caching allocator's (``torch.cuda.memory_stats``) on the card the
run uses; a run on the CPU has no such figure and reports none.  Host
RSS comes from ``/proc/self/status``, so the final report keeps the
reference benchmark's columns (per-frame ms, CPU%, memory MB).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, IO, List, Optional

import torch


def device_memory_stats(device=None) -> Dict[str, int]:
    """Allocator statistics of ``device`` in bytes, under the JAX
    package's key names (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved``, ``num_allocs``); ``{}`` for a CPU device or
    when no card is present.  ``None`` means the current card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    st = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": st.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": st.get("reserved_bytes.all.current", 0),
            "num_allocs": st.get("allocation.all.allocated", 0)}


_T_WALL0 = time.perf_counter()
_T_CPU0 = time.process_time()


def cpu_percent() -> float:
    """Mean process CPU utilization since import (%; above 100 with
    several threads busy, the reference's CPU column)."""
    dw = time.perf_counter() - _T_WALL0
    dc = time.process_time() - _T_CPU0
    return 100.0 * dc / max(dw, 1e-9)


def host_rss_bytes() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class MetricsRegistry:
    """Accumulates per-frame metric rows and optionally streams them as
    JSON lines.

    Row keys are free-form (track_ms, n_features, n_matches, n_inliers,
    ...); :meth:`summary` gives mean / min / max / count per numeric key.
    """

    def __init__(self, stream: Optional[IO[str]] = None):
        self.rows: List[Dict[str, Any]] = []
        self._stream = stream
        self._t0 = time.perf_counter()

    def emit(self, **kv: Any) -> Dict[str, Any]:
        row = {"t": time.perf_counter() - self._t0, **kv}
        self.rows.append(row)
        if self._stream is not None:
            self._stream.write(json.dumps(row) + "\n")
            self._stream.flush()
        return row

    def column(self, key: str) -> List[Any]:
        return [r[key] for r in self.rows if key in r]

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"n_rows": len(self.rows)}
        for key in {k for r in self.rows for k in r} - {"t"}:
            vals = [v for v in self.column(key) if isinstance(v, (int, float))]
            if vals:
                out[key] = {
                    "mean": sum(vals) / len(vals),
                    "min": min(vals),
                    "max": max(vals),
                    "count": len(vals),
                }
        return out

    def close(self) -> None:
        """Close the stream (the registry keeps its rows)."""
        if self._stream is not None:
            self._stream.close()
