"""Named-section stopwatch.

Counterpart of ``Timer`` in ``gslam_tpu/utils/timer.py``: named sections
accumulating count / total / min / max.  PyTorch returns before the card
finishes, so a section that times device work calls :meth:`Timer.block`
with the tensors it produced before it closes, which waits for the card
(``torch.cuda.synchronize``); on CPU tensors it returns at once.  Each
``KeyframeSLAM`` owns one timer (``slam.timer``).
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass
class _Section:
    count: int = 0
    total: float = 0.0
    min: float = math.inf
    max: float = 0.0
    _enter_t: Optional[float] = None

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Timer:
    """Accumulating named-section timer::

        with timer.section("slam/extract"):
            out = step(...)
            timer.block(out)      # wait for the card before the section ends
    """

    def __init__(self):
        self._sections: Dict[str, _Section] = {}

    def enter(self, name: str) -> None:
        sec = self._sections.setdefault(name, _Section())
        sec._enter_t = time.perf_counter()

    def leave(self, name: str) -> None:
        sec = self._sections.get(name)
        if sec is None or sec._enter_t is None:
            raise KeyError(f"timer.leave({name!r}) without matching enter")
        dt = time.perf_counter() - sec._enter_t
        sec._enter_t = None
        sec.count += 1
        sec.total += dt
        sec.min = min(sec.min, dt)
        sec.max = max(sec.max, dt)

    @contextmanager
    def section(self, name: str):
        self.enter(name)
        try:
            yield self
        finally:
            self.leave(name)

    @staticmethod
    def block(*tensors: torch.Tensor) -> None:
        """Wait for the card that holds any of ``tensors``."""
        for t in tensors:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
                return

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"count": s.count, "total": s.total, "mean": s.mean,
                   "min": s.min if s.count else 0.0, "max": s.max}
            for name, s in self._sections.items()
        }

    def reset(self) -> None:
        self._sections.clear()

    def table(self) -> str:
        rows = ["{:<28s} {:>8s} {:>12s} {:>12s} {:>12s} {:>12s}".format(
            "section", "count", "total(s)", "mean(ms)", "min(ms)", "max(ms)")]
        row = "{:<28s} {:>8d} {:>12.4f} {:>12.4f} {:>12.4f} {:>12.4f}"
        for name, s in sorted(self._sections.items()):
            rows.append(row.format(name, s.count, s.total, s.mean * 1e3,
                                   (s.min if s.count else 0.0) * 1e3,
                                   s.max * 1e3))
        return "\n".join(rows)


class TicToc:
    """Ad-hoc stopwatch: ``tic()`` then ``toc()`` (seconds)."""

    def __init__(self):
        self._t = time.perf_counter()

    def tic(self) -> None:
        self._t = time.perf_counter()

    def toc(self) -> float:
        return time.perf_counter() - self._t
