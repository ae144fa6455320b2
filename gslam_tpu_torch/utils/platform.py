"""Device probes: where the port may run and what card it runs on.

Counterpart of ``gslam_tpu/utils/platform.py``.  The port's entry points
run on the CUDA card unless the caller asks for the CPU; they never fall
back to the CPU silently, so :func:`require_device` raises when CUDA is
asked for and absent.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import torch


def require_device(device) -> torch.device:
    """``torch.device(device)``, raising if it is a CUDA device and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def nvcc_path() -> Optional[str]:
    """Path of the CUDA compiler, or None: $CUDA_HOME/bin, then PATH,
    then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, as
    one CSV line (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]
