"""Trajectory metrics: association, alignment, ATE, RPE.

Counterpart of the metrics of ``gslam_tpu/eval/trajectory.py``:
associate estimate and ground truth by timestamp, align with Umeyama
(SE3 for metric maps, Sim3 for monocular), report ATE RMSE and RPE.
Host-side numpy around a float32 Umeyama on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gslam_tpu_torch.core.sim3 import sim3_apply
from gslam_tpu_torch.core.so3 import quat_to_matrix
from gslam_tpu_torch.estimation.alignment import umeyama_alignment


def associate(t_est: np.ndarray, t_gt: np.ndarray,
              max_dt: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (TUM tooling behaviour):
    (idx_est, idx_gt) of the matched pairs, in time order."""
    t_est = np.asarray(t_est, np.float64)
    t_gt = np.asarray(t_gt, np.float64)
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1) if len(t_gt) > 1 else np.zeros_like(j)
    left = np.abs(t_gt[np.maximum(j - 1, 0)] - t_est)
    right = np.abs(t_gt[np.minimum(j, len(t_gt) - 1)] - t_est)
    jj = np.where(left <= right, np.maximum(j - 1, 0),
                  np.minimum(j, len(t_gt) - 1))
    dt = np.abs(t_gt[jj] - t_est)
    ok = dt <= max_dt
    # one GT sample may match several estimates; keep the closest
    used = set()
    idx_e = []
    for k in np.argsort(dt):
        if not ok[k] or jj[k] in used:
            continue
        used.add(jj[k])
        idx_e.append(k)
    idx_e = np.asarray(sorted(idx_e), np.int64)
    return idx_e, jj[idx_e]


def align_trajectory(p_est: np.ndarray, p_gt: np.ndarray,
                     with_scale: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Umeyama-align estimated positions onto GT: (aligned, sim3)."""
    src = torch.as_tensor(np.asarray(p_est, np.float32))
    S = umeyama_alignment(src, torch.as_tensor(np.asarray(p_gt, np.float32)),
                          with_scale=with_scale)
    return sim3_apply(S, src).numpy(), S.numpy()


def ate_rmse(p_est: np.ndarray, p_gt: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after alignment (meters)."""
    aligned, _ = align_trajectory(p_est, p_gt, with_scale)
    err = np.linalg.norm(aligned - p_gt, axis=-1)
    return float(np.sqrt((err ** 2).mean()))


def rpe(p_est: np.ndarray, p_gt: np.ndarray, delta: int = 1
        ) -> Tuple[float, float]:
    """Positions-only relative pose error over a frame delta:
    (translation RMSE, mean)."""
    d_est = p_est[delta:] - p_est[:-delta]
    d_gt = p_gt[delta:] - p_gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=-1)
    return float(np.sqrt((err ** 2).mean())), float(err.mean())


class TrajectoryMetrics(NamedTuple):
    ate_rmse: float
    rpe_rmse: float
    rpe_mean: float
    n_matched: int
    scale: float


def save_tum_trajectory(path: str, ts: np.ndarray,
                        poses_wc: np.ndarray) -> None:
    """Write a TUM-format trajectory: ``t tx ty tz qx qy qz qw`` a line,
    cam -> world (the TUM RGB-D benchmark tools' format)."""
    poses_wc = np.asarray(poses_wc)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p in zip(np.asarray(ts), poses_wc):
            w, x, y, z = p[3:7]  # wxyz -> the file's xyzw
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{x:.6f} {y:.6f} {z:.6f} {w:.6f}\n")


def load_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM-format trajectory -> (ts (N,), poses_wc (N, 7) with the
    quaternion as wxyz)."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(tok) for tok in line.split()]
            ts.append(v[0])
            poses.append([v[1], v[2], v[3], v[7], v[4], v[5], v[6]])
    return np.asarray(ts), np.asarray(poses, np.float32)


def save_kitti_trajectory(path: str, poses_wc: np.ndarray) -> None:
    """Write a KITTI-odometry trajectory: a line of 12 floats per pose,
    the row-major 3x4 [R|t] cam -> world in float32."""
    p = torch.as_tensor(np.asarray(poses_wc, np.float32)).reshape(-1, 7)
    M = torch.cat([quat_to_matrix(p[:, 3:7]), p[:, :3, None]], -1).numpy()
    with open(path, "w") as f:
        for m in M:
            f.write(" ".join(f"{v:.6e}" for v in m.reshape(-1)) + "\n")


def evaluate_trajectory(t_est: np.ndarray, p_est: np.ndarray,
                        t_gt: np.ndarray, p_gt: np.ndarray,
                        with_scale: bool = True, max_dt: float = 0.02,
                        rpe_delta: int = 1) -> TrajectoryMetrics:
    """Associate -> align -> ATE + RPE."""
    ie, ig = associate(t_est, t_gt, max_dt)
    if len(ie) < 3:
        return TrajectoryMetrics(np.inf, np.inf, np.inf, len(ie), 1.0)
    pe = np.asarray(p_est)[ie]
    pg = np.asarray(p_gt)[ig]
    aligned, S = align_trajectory(pe, pg, with_scale)
    err = np.linalg.norm(aligned - pg, axis=-1)
    ate = float(np.sqrt((err ** 2).mean()))
    rp = rpe(aligned, pg, rpe_delta)
    return TrajectoryMetrics(ate_rmse=ate, rpe_rmse=rp[0], rpe_mean=rp[1],
                             n_matched=len(ie), scale=float(S[7]))
