"""The plain reference that decides ``correct``: numpy in float64.

A SLAM system's answer for a frame is the camera's pose.  The scene is
synthetic, so the exact answer is known: the camera trajectory that the
scene is rendered from (:func:`camera_to_world`), computed here in
float64 from the scene's definition.  The reference judges the poses the
program returned by their relative pose error, which is free of the
gauge (the program's world is its first camera's frame): the error
motion between the returned and the true motion over one frame and over
one second of frames (the TUM benchmark's interval), its translation in
mm and its rotation in degrees, each as a median and a mean
(:func:`judge`).  The mean also feels a few answers that are far off;
the one-second numbers feel drift and a wrong scale.

Two controls put the reference's own trajectory in the program's place
with one of the configuration's guarantees broken each:
:func:`inverted_control` (a camera-to-world pose) and
:func:`skipping_control` (a pose of each frame's own).
:func:`ate_rmse` is the absolute trajectory error after a rigid Umeyama
alignment, which the calibration prints beside the numbers compared.

Nothing here imports the program, JAX or the JAX package: the harness
hands this module the poses the program returned, as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def camera_to_world(scene: dict, i: int):
    """(R_wc (3, 3), t_wc (3,)) of frame ``i`` of ``scene`` (a
    configuration's ``scene`` table): "line" moves ``step`` metres a frame
    along x; "ring_out" goes round a circle of ``radius`` looking outward,
    once in ``lap_frames`` frames."""
    motion = scene["motion"]
    if motion == "line":
        t = np.array([scene["step"] * i, 0.0, 0.0])
        yaw = 0.0
    elif motion == "ring_out":
        a = 2 * np.pi * i / max(scene["lap_frames"], 1)
        r = scene["radius"]
        t = np.array([r * np.sin(a), 0.0, -r * np.cos(a)])
        yaw = np.pi - a
    else:
        raise ValueError(f"unknown motion {motion!r}")
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    return R, t


def trajectory(scene: dict, n: int) -> np.ndarray:
    """(n, 4, 4) float64 camera-to-world matrices of an episode's first
    ``n`` frames."""
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        T[i, :3, :3], T[i, :3, 3] = camera_to_world(scene, i)
    return T


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotations, normalised."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def poses_to_matrices(poses: np.ndarray) -> np.ndarray:
    """(n, 7) cam->world [t, q wxyz] -> (n, 4, 4) float64."""
    p = np.asarray(poses, np.float64)
    T = np.tile(np.eye(4), (len(p), 1, 1))
    T[:, :3, :3] = quat_to_matrix(p[:, 3:7])
    T[:, :3, 3] = p[:, :3]
    return T


def align_rigid(src: np.ndarray, dst: np.ndarray):
    """Umeyama without scale: (R, t) minimising |R src + t - dst|."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt))])
    R = U @ D @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """ATE RMSE (m) of positions ``est`` (n, 3) after rigid alignment."""
    R, t = align_rigid(est, gt)
    err = np.linalg.norm(est @ R.T + t - gt, axis=-1)
    return float(np.sqrt((err ** 2).mean()))


def rpe_gaps(T_est: np.ndarray, T_gt: np.ndarray, delta: int = 1):
    """Translation gaps (m) and rotation gaps (degrees) of the relative
    motions over ``delta`` frames: for each pair (i, i + delta) the
    error motion inv(rel_gt) rel_est, its translation's length and its
    rotation's angle."""
    def rel(T):
        return np.linalg.inv(T[:-delta]) @ T[delta:]
    E = np.linalg.inv(rel(T_gt)) @ rel(T_est)
    cos = (np.trace(E[:, :3, :3], axis1=1, axis2=2) - 1.0) / 2.0
    return (np.linalg.norm(E[:, :3, 3], axis=-1),
            np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def judge(episodes: Sequence[dict]) -> Dict[str, float]:
    """The numbers compared, over ``episodes``: dicts of ``poses`` (n, 7)
    returned by the program for the first n frames of an episode, the
    configuration's ``scene`` table and the sensor's ``rate_hz``.  Over
    one frame (``rpe_*``, ``rot_*``) and over one second of frames
    (``rpe1s_*``, ``rot1s_*``, the TUM benchmark's interval): the median
    and the mean of the translation gaps (mm) and of the rotation gaps
    (degrees).  And ``stale_pct``, the share of frames after an
    episode's first whose pose repeats the one before it exactly: an
    answer that is not the frame's own.  A pose that is not finite reads
    as an infinite gap."""
    names = [(1, "rpe", "rot"), (None, "rpe1s", "rot1s")]
    got: Dict[str, List[np.ndarray]] = {}
    stale = []
    for ep in episodes:
        poses = np.asarray(ep["poses"], np.float64)
        n = len(poses)
        stale.append((np.diff(poses, axis=0) == 0).all(axis=1))
        for delta, tn, rn in names:
            d = delta or int(round(ep["rate_hz"]))
            if n <= d:
                continue
            if not np.isfinite(poses).all():
                tg = rg = np.array([np.inf])
            else:
                tg, rg = rpe_gaps(poses_to_matrices(poses),
                                  trajectory(ep["scene"], n), d)
            got.setdefault(tn, []).append(tg * 1e3)
            got.setdefault(rn, []).append(rg)
    out = {}
    for _, tn, rn in names:
        for name in (tn, rn):
            g = np.concatenate(got[name]) if name in got \
                else np.array([np.inf])
            unit = "mm" if name.startswith("rpe") else "deg"
            out[f"{name}_p50_{unit}"] = float(np.median(g))
            out[f"{name}_mean_{unit}"] = float(g.mean())
    st = np.concatenate(stale) if stale else np.array([True])
    out["stale_pct"] = float(st.mean()) * 100.0 if len(st) else 100.0
    return out


def to_poses(T: np.ndarray) -> np.ndarray:
    """(n, 4, 4) rotations about y -> (n, 7) [t, q wxyz]."""
    R = T[:, :3, :3]
    w = np.sqrt(np.clip(1.0 + np.trace(R, axis1=1, axis2=2), 0, None)) / 2
    y = np.copysign(np.sqrt(np.clip(1.0 - w * w, 0, None)), R[:, 0, 2])
    z = np.zeros(len(T))
    return np.concatenate([T[:, :3, 3], np.stack([w, z, y, z], -1)], -1)


def relative_truth(scene: dict, n: int) -> np.ndarray:
    """(n, 4, 4) true camera-to-world poses in the frame of the episode's
    first camera, the program's own world."""
    T = trajectory(scene, n)
    return np.linalg.inv(T[0]) @ T


def skipping_control(scene: dict, n: int) -> np.ndarray:
    """A control: the reference trajectory put in the program's place
    (cam->world [t, q wxyz], as the program returns it) with the
    guarantee of a pose of each frame's own broken: every other frame
    repeats the pose before it, as a tracker that skips frames to keep
    up would answer."""
    rel = relative_truth(scene, n)
    rel[1::2] = rel[0:n - 1:2]
    return to_poses(rel)


def inverted_control(scene: dict, n: int) -> np.ndarray:
    """A control: the reference trajectory put in the program's place
    with the guarantee of a camera-to-world pose broken: each frame
    answered with its world-to-camera pose, the tracker's own estimate
    before its last inversion."""
    return to_poses(np.linalg.inv(relative_truth(scene, n)))


def scale_control(scene: dict, n: int, factor: float) -> np.ndarray:
    """The reference trajectory with its positions ``factor`` times
    their size: a depth or a baseline read at the wrong scale."""
    rel = relative_truth(scene, n)
    rel[:, :3, 3] *= factor
    return to_poses(rel)
