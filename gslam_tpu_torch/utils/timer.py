"""Named spans and counters.

Counterpart of ``Timer`` in ``gslam_tpu/utils/timer.py``: named sections
accumulating count / total / min / max.  Each SLAM system owns one timer
(``slam.timer``); the process-wide :data:`timer` holds the app layer's
``app/*`` sections, which the CLI reports beside the system's.

A span, ``with timer.section(name)``, records:

- always, its host time (two ``perf_counter`` reads and a boolean test,
  no CUDA call).  PyTorch returns before the card finishes and no span
  waits for it, so this is the time the host spent in the layer:
  queueing its work, and waiting where the layer itself reads a result
  back (the packed fetch of ``slam/track_fused/fetch``);
- its parent, the innermost span of this timer open when it began
  (``stats()[name]["parent"]``).  A child span's name is its parent's
  with a suffix (``slam/track_fused/pnp`` inside ``slam/track_fused``);
- only while a ``torch.profiler`` records: one ``record_function`` range
  of its name, ``frame=<timer.frame>`` its args, so that the trace shows
  each program span beside the kernels it queued; and, where the
  process uses the card and the current stream is not capturing a graph,
  a pair of timing events on that stream.  :meth:`Timer.stats` resolves
  the pairs the card has passed into the entry ``"<name>:device"``: the
  span's length on the card's timeline.  A pair still in flight waits for
  a later call.

A counter, ``timer.count(name, value)``, adds one observation.  A value
that is a tensor is summed where it lies (on the card for a device
tensor) and read back only in :meth:`Timer.stats`, so a counter adds no
read to the frame path.  ``stats()`` reports it as ``{"count":
observations, "total": sum, "kind": "counter"}``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.autograd import profiler as _autograd_profiler

# event pairs a timer holds before it folds those the card has passed
_MAX_PENDING = 1024


@dataclass
class _Section:
    count: int = 0
    total: float = 0.0
    min: float = math.inf
    max: float = 0.0
    parent: Optional[str] = None

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    def row(self, kind: str) -> Dict[str, object]:
        return {"count": self.count, "total": self.total, "mean": self.mean,
                "min": self.min if self.count else 0.0, "max": self.max,
                "parent": self.parent, "kind": kind}


@dataclass
class _Counter:
    count: int = 0
    total: Union[float, torch.Tensor] = 0.0


class _Span:
    """One open span: its name, parent, start, and what a profiler got."""

    __slots__ = ("name", "parent", "t0", "range", "start")

    def __init__(self, name: str, parent: Optional[str]):
        self.name = name
        self.parent = parent
        self.t0 = 0.0
        self.range = None       # the record_function range
        self.start = None       # the start event on the card


class Timer:
    """Accumulating named spans and counters::

        timer.frame = frame.id
        with timer.section("slam/track_fused"):
            with timer.section("slam/track_fused/pnp"):
                T, inl, n = find_pnp(...)
        timer.count("slam/track_fused/inliers", n)
    """

    def __init__(self):
        self._sections: Dict[str, _Section] = {}
        self._device: Dict[str, _Section] = {}
        self._pending: List[Tuple[str, object, object]] = []
        self._counters: Dict[str, _Counter] = {}
        self._stack: List[_Span] = []
        #: the id of the frame being processed, the args of each range
        self.frame: Optional[int] = None

    # -- spans ---------------------------------------------------------
    def _open(self, name: str) -> None:
        span = _Span(name, self._stack[-1].name if self._stack else None)
        if _autograd_profiler._is_profiler_enabled:
            self._trace(span)
        self._stack.append(span)
        span.t0 = time.perf_counter()

    def _trace(self, span: _Span) -> None:
        """The span's profiler range, and its start on the card."""
        span.range = torch.profiler.record_function(
            span.name, f"frame={self.frame}")
        span.range.__enter__()
        if torch.cuda.is_initialized() and \
                not torch.cuda.is_current_stream_capturing():
            span.start = torch.cuda.Event(enable_timing=True)
            span.start.record()

    def _close(self, name: str) -> None:
        t1 = time.perf_counter()
        for k in range(len(self._stack) - 1, -1, -1):
            if self._stack[k].name == name:
                break
        else:
            raise KeyError(f"timer.leave({name!r}) without matching enter")
        span = self._stack.pop(k)
        sec = self._sections.get(name)
        if sec is None:
            sec = self._sections[name] = _Section(parent=span.parent)
        sec.add(t1 - span.t0)
        if span.start is not None and \
                not torch.cuda.is_current_stream_capturing():
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((name, span.start, end))
            if len(self._pending) >= _MAX_PENDING:
                # a long profiled run: fold the pairs the card has passed
                self._resolve()
        if span.range is not None:
            span.range.__exit__(None, None, None)

    def enter(self, name: str) -> None:
        """Open span ``name`` (for a caller that cannot use ``with``;
        :meth:`section` does not go through this method)."""
        self._open(name)

    def leave(self, name: str) -> None:
        """Close the innermost open span ``name``."""
        self._close(name)

    @contextmanager
    def section(self, name: str):
        self._open(name)
        try:
            yield self
        finally:
            self._close(name)

    # -- counters ------------------------------------------------------
    def count(self, name: str, value) -> None:
        """Add one observation of ``value`` (a number, or a tensor summed
        where it lies) to counter ``name``."""
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = _Counter()
        c.count += 1
        if isinstance(value, torch.Tensor):
            value = value.detach().double()
        c.total = c.total + value

    # -- reading -------------------------------------------------------
    def _resolve(self) -> None:
        """Fold the event pairs whose end the card has passed into the
        spans' device times."""
        keep = []
        for name, start, end in self._pending:
            if end.query():
                self._device.setdefault(name, _Section()).add(
                    start.elapsed_time(end) * 1e-3)
            else:
                keep.append((name, start, end))
        self._pending = keep

    def stats(self) -> Dict[str, Dict[str, object]]:
        """Each span's host time (``kind`` "span"), each span's time on the
        card as ``"<name>:device"`` (``kind`` "device", only where a
        profiler recorded), and each counter (``kind`` "counter")."""
        self._resolve()
        out = {name: s.row("span") for name, s in self._sections.items()}
        out.update((f"{name}:device", s.row("device"))
                   for name, s in self._device.items())
        out.update((name, {"count": c.count, "total": float(c.total),
                           "kind": "counter"})
                   for name, c in self._counters.items())
        return out

    def reset(self) -> None:
        self._sections.clear()
        self._device.clear()
        self._pending.clear()
        self._counters.clear()

    @classmethod
    def merged(cls, *timers: "Timer") -> "Timer":
        """A timer holding copies of the spans and counters of ``timers``
        (a later timer's entry wins a name that two share)."""
        out = cls()
        for t in timers:
            t._resolve()
            for mine, theirs in ((out._sections, t._sections),
                                 (out._device, t._device),
                                 (out._counters, t._counters)):
                for name, entry in theirs.items():
                    mine[name] = dataclasses.replace(entry)
        return out

    def table(self) -> str:
        st = self.stats()
        rows = ["{:<36s} {:>8s} {:>12s} {:>12s} {:>12s} {:>12s}".format(
            "section", "count", "total(s)", "mean(ms)", "min(ms)", "max(ms)")]
        row = "{:<36s} {:>8d} {:>12.4f} {:>12.4f} {:>12.4f} {:>12.4f}"
        for name, s in sorted(st.items()):
            if s["kind"] != "counter":
                rows.append(row.format(name, s["count"], s["total"],
                                       s["mean"] * 1e3, s["min"] * 1e3,
                                       s["max"] * 1e3))
        counters = sorted((n, s) for n, s in st.items()
                          if s["kind"] == "counter")
        if counters:
            rows.append("{:<36s} {:>8s} {:>12s} {:>12s}".format(
                "counter", "count", "total", "mean"))
            for name, s in counters:
                rows.append("{:<36s} {:>8d} {:>12.6g} {:>12.6g}".format(
                    name, s["count"], s["total"], s["total"] / s["count"]))
        return "\n".join(rows)

    def dump(self) -> None:
        if self._sections or self._counters:
            print(self.table())


class TicToc:
    """Ad-hoc stopwatch: ``tic()`` then ``toc()`` (seconds)."""

    def __init__(self):
        self._t = time.perf_counter()

    def tic(self) -> None:
        self._t = time.perf_counter()

    def toc(self) -> float:
        return time.perf_counter() - self._t


#: process-wide timer of the app layer (``app/frame``, ``app/viz_live``)
timer = Timer()
