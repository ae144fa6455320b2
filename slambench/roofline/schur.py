"""B5, the fused Schur reduction (``gslam_tpu_torch/csrc/schur.cu``,
``gslam_schur``: ``schur_groups`` then ``schur_total``).

Bytes: the inputs (poses, points, observations) read once, the outputs
(Hpp^-1, bp, W_e, S, b_s) written once.  Operations: per observation the
residual and weight (34), Jacobians (30), Hpp and bp (45), W_e (72),
Y = W_e Hpp^-1 (90), Hcc (84) and b (40); per point the 3 x 3 inverse
(40); per camera pair of a point the 6 x 6 block of U V^T (216).  The
observations and camera pairs are counted on each launch's own problem,
which the traced run records as the program calls the kernel
(``WATCH``), holding references only.
"""

from __future__ import annotations

import torch

KERNELS = ("schur_groups", "schur_total")
WATCH = ("gslam_tpu_torch.ops.cuda.schur", "schur_reduce_kernel")


def record(problem, *args, **kwargs):
    """What a launch's work needs, taken without a device read."""
    return problem.cam_pose.shape[0], problem.obs_cam, problem.obs_valid


def launch_work(C: int, obs_cam: torch.Tensor, obs_valid: torch.Tensor):
    """(bytes, operations) of one launch on a problem of ``C`` cameras."""
    P, O = obs_cam.shape
    n_obs = int(obs_valid.sum())
    # distinct cameras per point (a valid slot's camera; an invalid slot
    # that repeats it must not clear it)
    cams = torch.zeros((P, C), dtype=torch.bool, device=obs_cam.device)
    rows = torch.arange(P, device=obs_cam.device)[:, None].expand(P, O)
    cams[rows[obs_valid], obs_cam.long().clamp(0, C - 1)[obs_valid]] = True
    pairs = int((cams.sum(1) ** 2).sum())
    n_bytes = (C * 16 * 4 + P * 16 + P * O * 16
               + P * 48 + P * O * 72 + (36 * C * C + 42 * C) * 4)
    return n_bytes, n_obs * 395 + P * 40 + pairs * 216


def work(run):
    """(bytes, operations) of each launch the traced window recorded."""
    return [launch_work(*r) for r in run.records.get("schur", [])]
