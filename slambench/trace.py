"""The traced run: torch.profiler over the first part of the window.

While the trace is on, each timer section of the program
(``gslam_tpu_torch.utils.timer.Timer``) also opens a profiler range of
its name, and each kernel whose ``roofline/<kernel>.py`` has a ``WATCH``
records its launches' problems (references only, no device read).  :meth:`Tracer.
digest` reduces the raw events to what the readers take: the device's
busy seconds (the union of every device operation's interval, so
overlapping operations count once), each kernel's seconds and launches,
and the idle gaps between device operations, each named by the innermost
timer section open at its middle (``bench/other`` where none is: the rest
of ``track`` and the harness).
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import torch

ROOFLINE = Path(__file__).with_name("roofline")


@dataclass
class TraceData:
    window_s: float                       # host seconds the trace spanned
    busy_s: float                         # union of device op intervals
    kernels: Dict[str, Tuple[float, int]]  # name -> (seconds, launches)
    idle: Dict[str, float] = field(default_factory=dict)  # host range -> s
    n_device_ops: int = 0


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of ``intervals`` (start, end) as sorted disjoint ones."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def name_gaps(busy: List[Tuple[int, int]],
              ranges: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of idle device time between the ``busy`` intervals (ns),
    by the innermost host range (start, end, name) open at each gap's
    middle ("bench/other" where none is)."""
    # one sweep over range starts (0), gap middles (1) and range ends (2)
    # in time order, with the open ranges on a stack (they nest)
    points = [(a, 0, k) for k, (a, _, _) in enumerate(ranges)]
    points += [(b, 2, k) for k, (_, b, _) in enumerate(ranges)]
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    points += [((e0 + s1) // 2, 1, k) for k, (e0, s1) in enumerate(gaps)]
    idle: Dict[str, float] = {}
    stack: List[int] = []
    for _, kind, k in sorted(points):
        if kind == 0:
            stack.append(k)
        elif kind == 2:
            for j in range(len(stack) - 1, -1, -1):
                if stack[j] == k:
                    del stack[j]
                    break
        else:
            name = ranges[stack[-1]][2] if stack else "bench/other"
            e0, s1 = gaps[k]
            idle[name] = idle.get(name, 0.0) + (s1 - e0) * 1e-9
    return idle


class Tracer:
    """``start()`` at the window's start, ``stop()`` once ``seconds`` have
    passed (at a frame's end), then ``digest()``; ``records[kernel]``
    holds each watched kernel's recorded launches."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.records: Dict[str, list] = {}
        self._undo = []
        self._open: Dict[tuple, object] = {}
        self.prof = None
        self.t0 = None
        self.window_s = None

    # ------------------------------------------------------------------
    def due(self) -> bool:
        return self.prof is not None and self.window_s is None and \
            time.perf_counter() - self.t0 >= self.seconds

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        from gslam_tpu_torch.utils.timer import Timer
        enter, leave = Timer.enter, Timer.leave
        opened = self._open

        def traced_enter(timer, name):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            opened[id(timer), name] = rf
            enter(timer, name)

        def traced_leave(timer, name):
            leave(timer, name)
            rf = opened.pop((id(timer), name), None)
            if rf is not None:
                rf.__exit__(None, None, None)

        Timer.enter, Timer.leave = traced_enter, traced_leave
        self._undo.append(lambda: (setattr(Timer, "enter", enter),
                                   setattr(Timer, "leave", leave)))
        for path in sorted(ROOFLINE.glob("*.py")):
            mod = importlib.import_module(f"slambench.roofline.{path.stem}")
            if getattr(mod, "WATCH", None):
                self._watch(path.stem, mod)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t0 = time.perf_counter()

    def _watch(self, kernel: str, mod) -> None:
        owner = importlib.import_module(mod.WATCH[0])
        fn = getattr(owner, mod.WATCH[1])
        recs = self.records.setdefault(kernel, [])

        def watched(*args, **kwargs):
            recs.append(mod.record(*args, **kwargs))
            return fn(*args, **kwargs)

        setattr(owner, mod.WATCH[1], watched)
        self._undo.append(lambda: setattr(owner, mod.WATCH[1], fn))

    def stop(self) -> None:
        """End the trace (idempotent): wait for the device, then stop."""
        if self.prof is None or self.window_s is not None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        for rf in self._open.values():
            rf.__exit__(None, None, None)
        self._open.clear()
        while self._undo:
            self._undo.pop()()

    # ------------------------------------------------------------------
    def digest(self) -> TraceData:
        from torch.autograd import DeviceType

        dev, host = [], []
        events = self.prof.profiler.kineto_results.events()
        # a profiler range also shows on the device's timeline: not work
        ranged = {ev.name() for ev in events
                  if ev.device_type() != DeviceType.CUDA
                  and ev.is_user_annotation()}
        for ev in events:
            if ev.device_type() == DeviceType.CUDA:
                if not ev.is_user_annotation() and ev.name() not in ranged:
                    dev.append((ev.start_ns(), ev.end_ns(), ev.name()))
            elif ev.name() in ranged:
                host.append((ev.start_ns(), ev.end_ns(), ev.name()))
        kernels: Dict[str, Tuple[float, int]] = {}
        for a, b, name in dev:
            s, n = kernels.get(name, (0.0, 0))
            kernels[name] = (s + (b - a) * 1e-9, n + 1)
        busy = merge([(a, b) for a, b, _ in dev])
        return TraceData(
            window_s=self.window_s,
            busy_s=sum(b - a for a, b in busy) * 1e-9,
            kernels=kernels, idle=name_gaps(busy, host),
            n_device_ops=len(dev))
