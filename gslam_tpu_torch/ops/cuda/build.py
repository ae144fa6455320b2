"""Build and load the CUDA kernels of ``gslam_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exports plain C entry points and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` on first use,
then loaded with ``ctypes``.  The hash covers the source and the flags,
so an edited source is rebuilt.  :func:`build_all` starts one ``nvcc``
per source at once and waits for all of them.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from gslam_tpu_torch.utils.platform import nvcc_path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the seven kernel sources, and the measurement probes (an empty kernel
# and two integer loops; not ported kernels)
SOURCES = ("fastnms", "orient", "brief", "matcher", "gated", "schur", "vocab",
           "probe")

# -fmad=false: no a*b+c contraction, so float products and sums round
# exactly as the plain PyTorch versions' separate operations do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _lib_path(name: str, flags: Tuple[str, ...] = None) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = NVCC_FLAGS if flags is None else flags
    h = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{h[:16]}.so"


def build_all(names=SOURCES, flags: Tuple[str, ...] = None
              ) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together, with ``flags`` (``NVCC_FLAGS`` by default; a
    tuning run adds ``-D`` macros).  Returns each source's compiler
    output (register and shared-memory use, from ``-Xptxas -v``); raises
    with the compiler's messages if any build fails."""
    flags = NVCC_FLAGS if flags is None else flags
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    logs: Dict[str, str] = {}
    try:
        for name in names:
            out = _lib_path(name, flags)
            if out.exists():
                logs[name] = "cached"
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *flags, "-o", tmp, str(CSRC / f"{name}.cu")]
            procs.append((name, Path(tmp), out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, tmp, out, proc in procs:
            logs[name] = proc.communicate(timeout=900)[0]
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu ---\n{logs[name]}")
            else:
                os.replace(tmp, out)     # atomic: readers see whole files
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    finally:
        for _, tmp, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


def library(name: str, flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed, with
    ``flags`` (``-D`` macros of a tuning variant) added to
    ``NVCC_FLAGS``."""
    lib = _LIBS.get((name, flags))
    if lib is None:
        path = _lib_path(name, NVCC_FLAGS + flags)
        if not path.exists():
            build_all((name,), NVCC_FLAGS + flags)
        lib = _LIBS[name, flags] = ctypes.CDLL(str(path))
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: Tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose
    shape matches ``shape`` (None matches any extent)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_ptr() -> int:
    """The current PyTorch CUDA stream, as the kernels' launch stream."""
    return torch.cuda.current_stream().cuda_stream
