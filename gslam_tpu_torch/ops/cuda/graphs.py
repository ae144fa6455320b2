"""CUDA graphs, the counterpart of jitted JAX executables: :func:`run`
runs a body over a dict of input tensors eagerly or as a replay of its
graph from a :class:`GraphCache`, captured on a miss."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from gslam_tpu_torch.ops.cuda import add_launches, launch_counts


def tensor_leaves(x) -> List[torch.Tensor]:
    """The tensors of a nest of named tuples, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in tensor_leaves(v)]


def rebuild(like, values):
    """A tuple or named tuple of ``like``'s type holding ``values``."""
    values = list(values)
    return type(like)(*values) if hasattr(like, "_fields") else tuple(values)


def clone(x):
    """A copy of a nest of named tuples of tensors."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    return rebuild(x, (clone(v) for v in x))


class CapturedGraph:
    """``body`` over a dict of static input tensors as one CUDA graph.

    The first inputs are cloned into static buffers, the body runs once
    on a side stream (warm-up: libraries, caches and the kernels' first
    launches), then once under ``torch.cuda.graph``.  A call copies its
    inputs into the static buffers and replays; the outputs are the
    graph's own buffers, overwritten by the next replay.  Nothing falls
    back to the eager body: a failed capture or replay raises.  The
    capture restricts only its own thread (``thread_local``), so that
    another thread of the process (the app pipeline's consumers) may use
    the card meanwhile.  The graph keeps ``body``, and with it what the
    captured kernels read through it (a camera's parameters on the card).

    ``captured`` holds the kernel launches one replay makes, by the names
    of :func:`~gslam_tpu_torch.ops.cuda.launch_counts`.  The capture
    launches nothing, so what the wrappers counted during it is taken
    back, and every replay adds ``captured``: the counters read the
    launches the card ran, the warm-up's and the replays'.  ``replays``
    counts the replays, ``capture_s`` is the host seconds of the capture
    and instantiation, ``pool_bytes`` the graph's memory pool."""

    def __init__(self, body: Callable, inputs: Dict[str, torch.Tensor]):
        self.body = body
        self.static = {k: v.clone() for k, v in inputs.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body(self.static)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = body(self.static)
        self.graph.instantiate()
        self.capture_s = time.perf_counter() - t0
        after = launch_counts()
        self.captured = {k: after[k] - before[k] for k in after}
        add_launches({k: -n for k, n in self.captured.items()})
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.replays = 0

    def __call__(self, inputs: Dict[str, torch.Tensor]):
        for k, v in inputs.items():
            self.static[k].copy_(v)
        self.graph.replay()
        add_launches(self.captured)
        self.replays += 1
        return self.out


class GraphCache(dict):
    """Captured graphs by key, and the lock around their shared buffers.

    Scope rule: a body that reads only its inputs, the parameters in its
    key and what it holds (a camera, keyed by its parameters) is cached
    per process (:data:`PROCESS`, keys starting with the body's name), so
    that every system of the process replays one graph; a body bound to
    an object (a method reading its state) is cached in a cache that
    object holds."""

    def __init__(self):
        super().__init__()
        self.lock = threading.Lock()


# the process's graphs of bodies that read only their inputs and key
PROCESS = GraphCache()


def run(cache: GraphCache, key: tuple, body: Callable,
        inputs: Dict[str, torch.Tensor], *, enabled: bool, timer, span: str,
        replay_counter: Optional[str] = None):
    """``body(inputs)``: eagerly where ``enabled`` is False or an input
    is off the card, else by a replay of ``cache[key]``, captured on a
    miss (span ``<span>/capture``, its ``capture_s`` counted under
    ``<span>/capture_s`` on ``timer``).  Copy-in, replay and the copies
    of the outputs hold the cache's lock, so the result never aliases
    the graph's buffers.  ``replay_counter``, where given, observes 1 a
    replay and 0 an eager call."""
    if not enabled or not all(v.is_cuda for v in inputs.values()):
        if replay_counter:
            timer.count(replay_counter, 0)
        return body(inputs)
    with cache.lock:
        graph = cache.get(key)
        if graph is None:
            with timer.section(f"{span}/capture"):
                graph = cache[key] = CapturedGraph(body, inputs)
            timer.count(f"{span}/capture_s", graph.capture_s)
        out = clone(graph(inputs))
    if replay_counter:
        timer.count(replay_counter, 1)
    return out
