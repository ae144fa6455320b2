"""Final evaluation report: the reference benchmark's output table.

Counterpart of ``gslam_tpu/eval/report.py``: trajectory metrics with the
timer's sections and memory accounting (ATE / RPE, per-section ms, CPU%,
host and device memory MB; SURVEY section 5.5), under the same keys.
The device memory is the CUDA allocator's on the run's card
(:func:`~gslam_tpu_torch.utils.metrics.device_memory_stats`), 0 for a
run on the CPU.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from gslam_tpu_torch.eval.trajectory import TrajectoryMetrics
from gslam_tpu_torch.utils.metrics import (cpu_percent, device_memory_stats,
                                           host_rss_bytes)
from gslam_tpu_torch.utils.timer import Timer, timer as global_timer


class EvalReport:
    """``EvalReport(name, traj, timer, extra, device)``: ``timer``
    defaults to the process-wide timer (the CLI passes the app's
    sections merged with the system's), ``device`` to the current card
    when one is present."""

    def __init__(self, name: str, traj: Optional[TrajectoryMetrics] = None,
                 timer: Optional[Timer] = None,
                 extra: Optional[Dict[str, Any]] = None, device=None):
        self.name = name
        self.traj = traj
        self.timer = timer or global_timer
        self.extra = dict(extra or {})
        self.device = device

    def to_dict(self) -> Dict[str, Any]:
        mem = device_memory_stats(self.device)
        d: Dict[str, Any] = {
            "sequence": self.name,
            "host_rss_mb": host_rss_bytes() / 1e6,
            "device_hbm_mb": mem.get("bytes_in_use", 0) / 1e6,
            "cpu_percent": cpu_percent(),
            **self.extra,
        }
        if self.traj is not None:
            d.update(ate_rmse=self.traj.ate_rmse,
                     rpe_rmse=self.traj.rpe_rmse,
                     rpe_mean=self.traj.rpe_mean,
                     n_matched=self.traj.n_matched,
                     scale=self.traj.scale)
        d["timing"] = self.timer.stats()
        return d

    def json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=float)

    def table(self) -> str:
        d = self.to_dict()
        lines = [f"=== {self.name} ==="]
        if self.traj is not None:
            lines.append(
                f"ATE RMSE: {d['ate_rmse']:.4f} m   "
                f"RPE RMSE: {d['rpe_rmse']:.4f} m   "
                f"matched: {d['n_matched']}   scale: {d['scale']:.4f}")
        lines.append(f"host RSS: {d['host_rss_mb']:.1f} MB   "
                     f"device HBM: {d['device_hbm_mb']:.1f} MB   "
                     f"CPU: {d['cpu_percent']:.0f}%")
        for k, v in self.extra.items():
            lines.append(f"{k}: {v}")
        lines.append(self.timer.table())
        return "\n".join(lines)
