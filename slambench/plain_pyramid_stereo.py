"""The plain reference of the ``kitti00_stereo_orb`` configuration's stereo
depth: both images through the same pyramid, the match gated by octave.
Plain PyTorch in float32, one left keypoint at a time.

What ``correct`` judges is the pose (:mod:`slambench.reference`, against
the scene's exact trajectory).  This module is the plain reference for
what the pyramid configuration changes in the stereo layer, which tests
compare with the program's output:

- :func:`slot_levels`: the pyramid level of each keypoint slot.  Level i
  of an (H, W) image is (round(H / scale^i), round(W / scale^i)); each
  level's budget is max_kps times its share of the levels' summed area,
  rounded half to even, at least 8; level 0 takes what the rounding
  leaves; the levels fill their slots in order;
- :func:`stereo_match`: ORB-SLAM2's ``Frame::ComputeStereoMatches`` gate,
  for each left keypoint a loop over the right keypoints: a right
  keypoint is a candidate where its level is within one of the left
  one's, its row within ``v_tol * scale^level`` of the left row (ORB-SLAM2
  bands a right keypoint by its own level, 2 x its scale factor; here the
  left keypoint's level sets the band, so that one row test serves a left
  keypoint), and its disparity u_l - u_r in (0.1, ``max_disparity``];
  the least Hamming distance wins (the first of a tie) where it is at
  most ``max_dist``;
- :func:`stereo_depth`: fx x baseline / disparity, 0 where there is none.

Distances are integer popcounts of the descriptors' XOR, so a distance is
exact; the row band is the float64 product rounded once to float32, and
the gates and the depth quotient compare and divide float32 numbers, as
the program does.  Nothing here imports the program, JAX or the JAX
package.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from slambench.plain_stereo import popcount32

# a float32 matrix product may run in TF32 on the card: not here
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BITS = 256
MASKED = BITS + 1          # the distance of a pair that may not match


def level_shapes(height: int, width: int, n_levels: int,
                 scale: float) -> List[Tuple[int, int]]:
    return [(int(round(height / scale ** i)), int(round(width / scale ** i)))
            for i in range(n_levels)]


def level_budgets(height: int, width: int, n_levels: int, scale: float,
                  max_kps: int) -> List[int]:
    shapes = level_shapes(height, width, n_levels, scale)
    areas = [float(h * w) for h, w in shapes]
    total = sum(areas)
    budgets = [max(8, round(max_kps * a / total)) for a in areas]
    budgets[0] += max_kps - sum(budgets)
    return budgets


def slot_levels(height: int, width: int, n_levels: int, scale: float,
                max_kps: int) -> torch.Tensor:
    """(max_kps,) int64: the level of each keypoint slot."""
    out: List[int] = []
    for level, k in enumerate(level_budgets(height, width, n_levels, scale,
                                            max_kps)):
        out += [level] * k
    return torch.tensor(out, dtype=torch.int64)


def stereo_match(desc_l, valid_l, uv_l, lev_l, desc_r, valid_r, uv_r, lev_r,
                 scale: float, max_disparity: float = 128.0,
                 v_tol: float = 2.0, max_dist: float = 64.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(disparity (Kl,) float32, valid (Kl,)) under the octave gate: u_l -
    u_r of the right keypoint with the least distance among the
    candidates (the first of a tie), 0 and False where none within
    ``max_dist`` passes."""
    Kl = desc_l.shape[0]
    disp = torch.zeros(Kl, dtype=torch.float32, device=desc_l.device)
    ok = torch.zeros(Kl, dtype=torch.bool, device=desc_l.device)
    uv_l, uv_r = uv_l.to(torch.float32), uv_r.to(torch.float32)
    lev_r = lev_r.to(torch.int64)
    for i in range(Kl):
        if not bool(valid_l[i]):
            continue
        level = int(lev_l[i])
        band = torch.tensor(v_tol * scale ** level, dtype=torch.float32)
        du = uv_l[i, 0] - uv_r[:, 0]
        dv = (uv_l[i, 1] - uv_r[:, 1]).abs()
        gate = ((du > 0.1) & (du <= max_disparity) & (dv <= band)
                & ((lev_r - level).abs() <= 1) & valid_r)
        dist = popcount32(torch.bitwise_xor(desc_l[i][None, :],
                                            desc_r)).sum(-1)
        d = torch.where(gate, dist, torch.full_like(dist, MASKED))
        j = int(torch.argmin(d))          # the first minimum
        if int(d[j]) <= max_dist:
            disp[i], ok[i] = du[j], True
    return disp, ok


def stereo_depth(disparity: torch.Tensor, valid: torch.Tensor, fx: float,
                 baseline: float) -> torch.Tensor:
    """fx x baseline / disparity in float32, 0 where there is none."""
    num = torch.tensor(fx * baseline, dtype=torch.float32,
                       device=disparity.device)
    depth = torch.zeros_like(disparity)
    ok = valid & (disparity > 1e-3)
    depth[ok] = num / disparity[ok]
    return depth
