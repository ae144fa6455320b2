"""Robust M-estimator weights for IRLS: counterparts of
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


def cauchy_weight(e: torch.Tensor, c: float) -> torch.Tensor:
    return 1.0 / (1.0 + (e / c) ** 2)


def tukey_weight(e: torch.Tensor, c: float) -> torch.Tensor:
    w = (1.0 - (e / c) ** 2) ** 2
    return torch.where(e.abs() <= c, w, torch.zeros_like(w))
