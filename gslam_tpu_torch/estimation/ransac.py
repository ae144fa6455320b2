"""Batched RANSAC: B hypotheses sampled, fitted and scored at once.

Counterpart of ``gslam_tpu/estimation/ransac.py``.  Random numbers come
from an explicit ``torch.Generator``; a caller that must reproduce the
reference's draws passes them as ``uniforms`` (B, k) instead (the tests
feed ``jax.random.uniform(key, (B, k))``, which are exactly the draws the
reference makes from ``key``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch


def num_hypotheses(min_set: int, inlier_ratio: float = 0.4,
                   confidence: float = 0.999, cap: int = 1024) -> int:
    """Classical RANSAC sample count, rounded up to a multiple of 8."""
    w = max(1e-3, inlier_ratio) ** min_set
    n = math.log(max(1e-12, 1.0 - confidence)) / math.log(max(1e-12, 1.0 - w))
    return min(cap, max(8, int(-(-n // 8) * 8)))


def ransac_sample_indices(valid: torch.Tensor, B: int, k: int,
                          generator: Optional[torch.Generator] = None,
                          uniforms: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """(B, k) index samples, uniform over the valid entries.

    A stable argsort moves valid indices to the front in index order;
    (B, k) uniforms pick positions below the valid count.  Within-sample
    collisions are tolerated, as in the reference: such a minimal set
    scores about zero inliers.
    """
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    V = valid.sum().clamp_min(1)
    if uniforms is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or explicit uniforms")
        uniforms = torch.rand((B, k), generator=generator,
                              device=valid.device)
    elif uniforms.shape != (B, k):
        raise ValueError(f"uniforms must have shape {(B, k)}, got "
                         f"{tuple(uniforms.shape)}")
    # clip to V-1: floor(u * V) reaches V when u is within 1 ulp of 1.0
    pos = torch.floor(uniforms.to(valid.device) * V).long()
    pos = torch.minimum(pos.clamp_min(0), V - 1)
    return order[pos]


def run_ransac(fit_fn: Callable[[torch.Tensor], torch.Tensor],
               residual_fn: Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor],
               data: torch.Tensor, valid: torch.Tensor, min_set: int,
               threshold: float, B: int,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generic batched RANSAC.

    fit_fn: (B, k, D) minimal samples -> (B, P) models
    residual_fn: ((..., P) models, (N, D) data) -> (..., N) residuals
    Returns (best_model, inlier_mask (N,), inlier_count).
    """
    idx = ransac_sample_indices(valid, B, min_set, generator, uniforms)
    models = fit_fn(data[idx])                          # (B, P)
    res = residual_fn(models, data)                     # (B, N)
    good = torch.isfinite(res) & (res < threshold) & valid[None, :]
    best = torch.argmax(good.sum(dim=1))                # first maximum
    # index_select: indexing by a 0-d tensor would read it on the host
    best_model = models.index_select(0, best.reshape(1))[0]
    best_res = residual_fn(best_model, data)
    inliers = torch.isfinite(best_res) & (best_res < threshold) & valid
    return best_model, inliers, inliers.sum()
