"""Robust M-estimator weight for IRLS: counterpart of ``huber_weight`` in
``gslam_tpu/opt/robust.py`` (w(e) with e the unsquared residual norm)."""

from __future__ import annotations

import torch

_EPS = 1e-12


def huber_weight(e: torch.Tensor, delta: float) -> torch.Tensor:
    """1 inside |e| <= delta, delta / |e| outside.  The quotient is a
    tensor division: ``scalar / tensor`` would multiply by a reciprocal
    and round differently from the reference."""
    a = e.abs()
    d = torch.full((), delta, dtype=a.dtype, device=a.device)
    return torch.where(a <= delta, torch.ones_like(a), d / a.clamp_min(_EPS))
