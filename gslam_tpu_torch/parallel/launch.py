"""Process-group set-up and a local launcher.

Counterpart of ``gslam_tpu/parallel/launch.py``.  A JAX process drives
n devices, a PyTorch process one rank, so :func:`spawn` plays the part
of the reference's one-process ``shard_map``: it starts ``world``
processes on this host, each joins the group, runs ``fn`` and sends back
its result.  A multi-host launch starts one process per rank and calls
:func:`initialize_distributed` in each with the same coordinator.

The backend is the caller's: ``"nccl"`` for ranks on cards (one rank a
card), ``"gloo"`` for the CPU.  A world of several ranks on one card
runs on gloo with every rank's tensors on ``cuda:0``; its collectives
stage their payloads through the host
(:mod:`gslam_tpu_torch.parallel.dist_ba`).
"""

from __future__ import annotations

import datetime
import io
import multiprocessing as mp
import queue
import socket
import time
import traceback
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from gslam_tpu_torch.parallel.mesh import make_mesh


def default_backend(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: int = 1, process_id: int = 0,
                           backend: Optional[str] = None, device="cuda",
                           timeout_s: float = 60.0) -> None:
    """Join the process group at ``tcp://coordinator`` (host:port) as
    rank ``process_id`` of ``num_processes``, on ``backend``
    (:func:`default_backend` of ``device`` when None).  A no-op for one
    process with no coordinator."""
    if coordinator is None:
        if num_processes > 1:
            raise ValueError("several processes need a coordinator")
        return
    dist.init_process_group(
        backend or default_backend(device), init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(shape: Optional[Tuple[int, int]] = None, device="cuda"):
    """A ('pt', 'obs') mesh over every rank of the group: (n, 1) for odd
    n or n <= 2, else (n // 2, 2)."""
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1) if n % 2 or n <= 2 else (n // 2, 2)
    return make_mesh(shape, device=device)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, device, backend, args, timeout_s,
               results):
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    initialize_distributed(f"localhost:{port}", world, rank, backend, device,
                           timeout_s)
    sent = False
    try:
        out = fn(rank, world, *args)
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, True, buf.getvalue()))
        sent = True
    finally:
        if not sent:
            results.put((rank, False, traceback.format_exc()))
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device="cuda",
          backend: Optional[str] = None, args: tuple = (),
          timeout_s: float = 600.0, pg_timeout_s: float = 60.0) -> List:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes that
    form one process group on ``backend`` (:func:`default_backend` of
    ``device``; a CUDA rank r works on card r % the card count), and
    return each rank's result, in rank order, on the CPU.

    ``fn`` must be importable by name (a module-level function).  The
    group's collectives time out after ``pg_timeout_s``; if the ranks
    have not all answered and exited within ``timeout_s``, or one fails,
    every rank is stopped and this raises with the failing rank's
    traceback."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, str(device), backend, args,
                               pg_timeout_s, results), daemon=True)
             for r in range(world)]
    out = [None] * world
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        got = 0
        while got < world:
            if time.monotonic() > deadline:
                raise RuntimeError(f"spawn: {world - got} of {world} ranks "
                                   f"gave no result within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: rank(s) {dead} exited with "
                                       "no result") from None
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
            out[rank] = torch.load(io.BytesIO(payload), map_location="cpu",
                                   weights_only=False)
            got += 1
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"spawn: ranks did not exit cleanly: {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
    return out
