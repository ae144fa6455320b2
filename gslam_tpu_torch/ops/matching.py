"""Descriptor matching: brute-force Hamming with ratio and mutual checks.

Counterpart of ``match_descriptors`` in ``gslam_tpu/ops/matching.py``.
The plain version forms the (N, M) distance matrix as a +/-1 float32
matrix product (exact: integer sums of at most 256 terms), then reduces
it.  Ties break by lowest index everywhere, as ``lax.top_k`` and
``jnp.argmin`` do in the reference.  The CUDA matcher in
:mod:`gslam_tpu_torch.ops.cuda.matcher` computes the same four
reductions (:func:`hamming_top2`) without forming the matrix; both feed
:func:`matches_from_top2`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gslam_tpu_torch.ops.frontend import DESC_WORDS

BITS = DESC_WORDS * 32
INF_DIST = float(BITS + 1)      # distance of a masked (invalid) pair


class Matches(NamedTuple):
    """Fixed-size match set A->B."""

    idx: torch.Tensor    # (N,) int32 index into B (-1 invalid)
    dist: torch.Tensor   # (N,) float32 Hamming distance
    valid: torch.Tensor  # (N,) bool
    count: torch.Tensor  # () int32


def unpack_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """(N, DESC_WORDS) int32 words -> (N, BITS) +/-1 float32."""
    n = desc.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & 1
    return (bits.to(torch.float32) * 2.0 - 1.0).reshape(n, BITS)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor
                   ) -> torch.Tensor:
    """(N, W) x (M, W) packed words -> (N, M) f32 Hamming distances."""
    dot = unpack_descriptors(desc_a) @ unpack_descriptors(desc_b).T
    return (BITS - dot) * 0.5


def _row_top2(D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(best, second, idx) per row of a masked (N, M) distance matrix:
    the first minimum on ties, ``second`` the least distance once the
    best column is removed."""
    best, idx = torch.min(D, dim=1)
    cols = torch.arange(D.shape[1], device=D.device)
    second = torch.where(cols[None, :] == idx[:, None],
                         D.new_full((), INF_DIST), D).amin(1)
    return best, second, idx.to(torch.int32)


def hamming_top2(desc_a: torch.Tensor, valid_a: torch.Tensor,
                 desc_b: torch.Tensor, valid_b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Per-row best and second-best distance and best column, and
    per-column best row, of the masked (N, M) distance matrix.

    Invalid pairs count as distance BITS + 1.  ``second`` is the least
    distance once the best column is removed, so it equals ``best`` when
    two columns tie.  A column masked in every row points back to row 0.
    """
    D = hamming_matrix(desc_a, desc_b)
    D = torch.where(valid_a[:, None] & valid_b[None, :], D,
                    D.new_full((), INF_DIST))
    back = torch.argmin(D, dim=0)         # first minimum on ties
    return (*_row_top2(D), back.to(torch.int32))


def matches_from_top2(best: torch.Tensor, second: torch.Tensor,
                      idx: torch.Tensor, back: torch.Tensor,
                      valid_a: torch.Tensor, max_dist: float = 64.0,
                      ratio: float = 0.8, mutual: bool = True) -> Matches:
    """Lowe ratio, ``max_dist`` and (optionally) mutual check."""
    ok = valid_a & (best <= max_dist) & (best <= ratio * second)
    if mutual:
        rows = torch.arange(best.shape[0], device=best.device,
                            dtype=torch.int32)
        ok = ok & (back[idx.long()] == rows)
    return Matches(idx=torch.where(ok, idx, idx.new_full((), -1)),
                   dist=torch.where(ok, best, best.new_full((), INF_DIST)),
                   valid=ok,
                   count=ok.sum().to(torch.int32))


def match_descriptors(desc_a: torch.Tensor, valid_a: torch.Tensor,
                      desc_b: torch.Tensor, valid_b: torch.Tensor,
                      max_dist: float = 64.0, ratio: float = 0.8,
                      mutual: bool = True) -> Matches:
    """Brute-force Hamming matching with Lowe ratio + mutual check (the
    plain version of the CUDA matcher)."""
    return matches_from_top2(*hamming_top2(desc_a, valid_a, desc_b,
                                           valid_b),
                             valid_a, max_dist=max_dist, ratio=ratio,
                             mutual=mutual)


def gate_squared(gate_radius: float) -> float:
    """The squared gate radius as the reference forms it: the float32
    radius squared in float32."""
    g = np.float32(gate_radius)
    return float(g * g)


def hamming_top2_gated(desc_a: torch.Tensor, valid_a: torch.Tensor,
                       desc_b: torch.Tensor, valid_b: torch.Tensor,
                       uv_a: torch.Tensor, uv_b: torch.Tensor,
                       gate2: float) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(best, second, idx) per row of the (N, M) distance matrix masked
    by validity and by the squared pixel distance ``gate2``: the plain
    version of the gated matcher kernel (B4).  Ties go to the lowest
    column; ``second`` equals ``best`` when two columns tie."""
    D = hamming_matrix(desc_a, desc_b)
    d2 = ((uv_a[:, None, :] - uv_b[None, :, :]) ** 2).sum(-1)
    ok = valid_a[:, None] & valid_b[None, :] & (d2 <= gate2)
    D = torch.where(ok, D, D.new_full((), INF_DIST))
    return _row_top2(D)


def match_descriptors_gated(desc_a: torch.Tensor, valid_a: torch.Tensor,
                            desc_b: torch.Tensor, valid_b: torch.Tensor,
                            uv_a: torch.Tensor, uv_b: torch.Tensor,
                            gate_radius: float, max_dist: float = 64.0,
                            ratio: float = 0.9) -> Matches:
    """Projection-gated matching (search by projection): pairs are
    candidates only within ``gate_radius`` pixels (uv_a: projected map
    points, uv_b: keypoints); ratio and ``max_dist`` tests, no mutual
    check.  Counterpart of ``match_descriptors_gated`` in the JAX
    package."""
    best, second, idx = hamming_top2_gated(
        desc_a, valid_a, desc_b, valid_b, uv_a, uv_b,
        gate_squared(gate_radius))
    return matches_from_top2(best, second, idx, None, valid_a,
                             max_dist=max_dist, ratio=ratio, mutual=False)


def match_descriptors_word_gated(desc_a: torch.Tensor, valid_a: torch.Tensor,
                                 words_a: torch.Tensor,
                                 desc_b: torch.Tensor, valid_b: torch.Tensor,
                                 words_b: torch.Tensor,
                                 max_dist: float = 64.0, ratio: float = 0.9,
                                 level_div: int = 1) -> Matches:
    """Word-gated matching: pairs are candidates only when both
    descriptors fall under the same vocabulary node at the gating level.
    ``level_div`` = k^(L - l): leaf words integer-divided by it give the
    level-l node id (1 gates at the leaf itself); unassigned (-1) words
    never match.  Ratio and ``max_dist`` tests, no mutual check.
    Counterpart of ``match_descriptors_word_gated`` in the JAX package
    (tensor operations there too, no kernel)."""
    D = hamming_matrix(desc_a, desc_b)
    na = torch.div(words_a, level_div, rounding_mode="floor")
    nb = torch.div(words_b, level_div, rounding_mode="floor")
    ok = (valid_a[:, None] & valid_b[None, :]
          & (words_a[:, None] >= 0) & (words_b[None, :] >= 0)
          & (na[:, None] == nb[None, :]))
    D = torch.where(ok, D, D.new_full((), INF_DIST))
    return matches_from_top2(*_row_top2(D), None, valid_a,
                             max_dist=max_dist, ratio=ratio, mutual=False)
