"""The plain reference of the stereo configuration's own operations: plain
PyTorch in float32, one keypoint at a time.

What ``correct`` judges is the pose (:mod:`slambench.reference`, against
the scene's exact trajectory).  This module is the plain reference for
the two operations that the stereo configuration adds to the path, which
tests compare with the program's output:

- :func:`stereo_match` and :func:`stereo_depth`: for each left keypoint,
  a loop over the right keypoints under the rectified gate (the same row
  within ``v_tol``, disparity in (0.1, ``max_disparity``]), the Hamming
  distance of their descriptors, the first minimum, kept at a distance of
  at most ``max_dist``; depth = fx x baseline / disparity;
- :func:`match_bruteforce`: brute-force Hamming nearest neighbours with
  Lowe's ratio test and the mutual check, the matching of the path that
  tracks a frame against its reference keyframe with no pose prior.

Descriptors are (K, 8) int32 words, 256 bits, as the program packs them.
Hamming distances are integer popcounts of the words' XOR, so a distance
is exact; the comparisons that the program makes in float32 (the ratio
test, the disparity gate, the depth quotient) are made here in float32
too.  Nothing here imports the program, JAX or the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

# a float32 matrix product may run in TF32 on the card: not here
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BITS = 256
MASKED = BITS + 1          # the distance of a pair that may not match


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as int64)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def hamming_row(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,) int64 Hamming distances of one descriptor (W,) to ``b`` (M, W)."""
    return popcount32(torch.bitwise_xor(a[None, :], b)).sum(-1)


def stereo_match(desc_l, valid_l, uv_l, desc_r, valid_r, uv_r,
                 max_disparity: float = 128.0, v_tol: float = 2.0,
                 max_dist: float = 64.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(disparity (Kl,) float32, valid (Kl,)): u_l - u_r of the right
    keypoint with the least distance under the gate (the first of a tie),
    0 and False where none within ``max_dist`` passes."""
    Kl = desc_l.shape[0]
    disp = torch.zeros(Kl, dtype=torch.float32, device=desc_l.device)
    ok = torch.zeros(Kl, dtype=torch.bool, device=desc_l.device)
    uv_l, uv_r = uv_l.to(torch.float32), uv_r.to(torch.float32)
    for i in range(Kl):
        if not bool(valid_l[i]):
            continue
        du = uv_l[i, 0] - uv_r[:, 0]
        dv = (uv_l[i, 1] - uv_r[:, 1]).abs()
        gate = (du > 0.1) & (du <= max_disparity) & (dv <= v_tol) & valid_r
        d = torch.where(gate, hamming_row(desc_l[i], desc_r),
                        torch.full_like(du, MASKED, dtype=torch.int64))
        j = int(torch.argmin(d))          # the first minimum
        if int(d[j]) <= max_dist:
            disp[i], ok[i] = du[j], True
    return disp, ok


def stereo_depth(disparity: torch.Tensor, valid: torch.Tensor, fx: float,
                 baseline: float) -> torch.Tensor:
    """fx x baseline / disparity in float32; 0 where there is none (the
    quotient over an infinite disparity)."""
    num = torch.tensor(fx * baseline, dtype=torch.float32,
                       device=disparity.device)
    d = torch.where(valid & (disparity > 1e-3), disparity,
                    torch.full_like(disparity, float("inf")))
    return num / d


def match_bruteforce(desc_a, valid_a, desc_b, valid_b, max_dist: float = 64.0,
                     ratio: float = 0.9
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx (N,) int64, -1 where no match; valid (N,)): for each row of
    ``desc_a`` the column of ``desc_b`` at the least distance (the first of
    a tie), kept where that distance is at most ``max_dist`` and at most
    ``ratio`` times the least distance to any other column (in float32),
    and where the column's own least-distance row is this one."""
    N, M = desc_a.shape[0], desc_b.shape[0]
    D = torch.empty((N, M), dtype=torch.int64, device=desc_a.device)
    for i in range(N):
        D[i] = torch.where(valid_a[i] & valid_b, hamming_row(desc_a[i],
                                                             desc_b),
                           torch.full((M,), MASKED, dtype=torch.int64,
                                      device=desc_a.device))
    idx = torch.full((N,), -1, dtype=torch.int64, device=desc_a.device)
    ok = torch.zeros(N, dtype=torch.bool, device=desc_a.device)
    back = torch.argmin(D, dim=0)
    r = torch.tensor(ratio, dtype=torch.float32)
    for i in range(N):
        j = int(torch.argmin(D[i]))
        best = float(D[i, j])
        rest = torch.cat([D[i, :j], D[i, j + 1:]])
        second = float(rest.min()) if len(rest) else float(MASKED)
        keep = (bool(valid_a[i]) and best <= max_dist
                and torch.tensor(best, dtype=torch.float32)
                <= r * torch.tensor(second, dtype=torch.float32)
                and int(back[j]) == i)
        if keep:
            idx[i], ok[i] = j, True
    return idx, ok
