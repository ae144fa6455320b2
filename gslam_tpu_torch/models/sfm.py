"""Offline global structure from motion: the TheiaSfM plugin analog.

Counterpart of ``gslam_tpu/models/sfm.py``.  ``track(frame)`` buffers;
:meth:`GlobalSfM.finalize` reconstructs once, in stages:

1. extraction per frame (B1, B2);
2. every pair i < j: all-pairs Hamming matching (B3) and two-view H / E
   geometry with cheirality decomposition;
3. rotation averaging: the top three eigenvectors of the (3F, 3F)
   connection matrix of pairwise rotations, projected to SO(3), with
   IRLS reweighting seeded by a maximum spanning tree (host numpy, as in
   the JAX package);
4. per-edge translation directions re-derived with the averaged
   rotations fixed (a 3x3 eigenvector, sign by a cheirality vote);
5. translation recovery: a joint linear least-squares of camera centres
   and edge scales, IRLS (host numpy);
6. tracks by union-find over the inlier matches (host);
7. two-view triangulation of each track from its extreme observations;
8. global bundle adjustment (B5, B6 up to 32 cameras), pruned at 5 and
   then 3 sigma and re-run.

Scale is a gauge (monocular): judge the result by ATE after Sim3
alignment.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gslam_tpu_torch.app.registry import SLAMS
from gslam_tpu_torch.core.camera import Camera
from gslam_tpu_torch.core.se3 import se3_identity, se3_inverse, se3_make
from gslam_tpu_torch.core.so3 import (
    matrix_to_quat, quat_rotate, quat_to_matrix,
)
from gslam_tpu_torch.datasets.base import FrameData
from gslam_tpu_torch.estimation.epipolar import triangulate
from gslam_tpu_torch.estimation.init2view import (
    two_view_draws, two_view_geometry,
)
from gslam_tpu_torch.ops.cuda.matcher import match_hamming
from gslam_tpu_torch.ops.frontend import extract_features
from gslam_tpu_torch.ops.matching import match_descriptors
from gslam_tpu_torch.opt.ba import (
    BundleProblem, bundle_adjust, reprojection_errors, resolve_ba_kernels,
)
from gslam_tpu_torch.utils.logging import get_logger
from gslam_tpu_torch.utils.platform import require_device
from gslam_tpu_torch.utils.timer import Timer

log = get_logger(__name__)


class PairGeometry(NamedTuple):
    """Two-view geometry of one frame pair (i -> j)."""

    T_ji: torch.Tensor        # (7,) relative SE3: x_j = T_ji * x_i, |t|=1
    n_inliers: torch.Tensor   # () int32 essential-inlier count
    match_idx: torch.Tensor   # (K,) int32 kp index in j per kp of i (-1)
    match_ok: torch.Tensor    # (K,) bool  match is an essential inlier


def pair_geometry(desc_i, valid_i, rays_i, desc_j, valid_j, rays_j,
                  sigma: float, uniforms, ransac_B: int = 256,
                  use_kernels: bool = True) -> PairGeometry:
    """Match one pair (B3 with ``use_kernels``) and estimate its relative
    pose by two-view geometry with H / E model selection; ``uniforms``
    are the RANSAC draws ((B, 8), (B, 4)) and ``sigma`` the keypoint
    noise in normalized units."""
    match = match_hamming if use_kernels else match_descriptors
    m = match(desc_i, valid_i, desc_j, valid_j)
    r2 = rays_j[m.idx.clamp_min(0).long()]
    tv = two_view_geometry(rays_i[:, :2], r2[:, :2], m.valid, sigma=sigma,
                           B=ransac_B, uniforms=uniforms)
    ok = m.valid & tv.inliers
    return PairGeometry(T_ji=tv.T_21, n_inliers=ok.sum().to(torch.int32),
                        match_idx=torch.where(ok, m.idx,
                                              m.idx.new_full((), -1)),
                        match_ok=ok)


def _edge_direction(Rji: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                    ok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translation direction of one edge given its relative rotation.

    Each inlier pair (x1, x2) of z = 1 rays constrains x2^T [t]x R x1 =
    0, i.e. t . ((R x1) x x2) = 0: t is the null vector of the stacked
    cross products (a 3x3 eigenvector), sign by a cheirality vote.
    Returns (t in camera j (3,), support count)."""
    Rx1 = x1 @ Rji.T
    M = torch.linalg.cross(Rx1, x2, dim=-1) * ok[:, None].to(x1.dtype)
    A = M.T @ M
    _, v = torch.linalg.eigh(A)
    t = v[:, 0]
    q = matrix_to_quat(Rji)
    eye = se3_identity(dtype=t.dtype, device=t.device)

    def count(tt):
        T21 = se3_make(tt, q)
        X, d1 = triangulate(eye, T21, x1[:, :2], x2[:, :2])
        d2 = (quat_rotate(q, X) + tt)[..., 2]
        return torch.sum((d1 > 0) & (d2 > 0) & ok)

    cp, cm = count(t), count(-t)
    return torch.where(cm > cp, -t, t), torch.maximum(cp, cm)


_edge_directions = torch.func.vmap(_edge_direction)


def rotation_averaging(edges_ij: np.ndarray, R_rel: np.ndarray,
                       weights: np.ndarray, n_frames: int,
                       irls_rounds: int = 3,
                       huber_deg: float = 10.0) -> np.ndarray:
    """Spectral chordal-L2 rotation averaging with IRLS outlier damping.

    edges_ij: (E, 2) int frame pairs (i, j); R_rel: (E, 3, 3) with R_j =
    R_rel @ R_i (world->cam); weights: (E,) >= 0.  Returns (F, 3, 3)
    float32 global rotations R_i (world->cam), up to a common gauge.

    The symmetric (3F, 3F) connection matrix with block [j, i] = w R_rel
    gives its top three eigenvectors; each 3x3 row block is projected to
    SO(3) (Procrustes).  Edges are reweighted after each solve by a
    Geman-McClure factor on their residual angle; a maximum spanning
    tree seeds the weights, and a last hard trim drops residual
    outliers.  Host numpy, as in the JAX package."""
    F = n_frames
    i, j = edges_ij[:, 0], edges_ij[:, 1]
    w0 = weights.astype(np.float32).copy()
    w = w0.copy()

    def solve(w):
        ww = w[:, None, None].astype(np.float32)
        Gn = np.zeros((F, F, 3, 3), np.float32)
        np.add.at(Gn, (j, i), ww * R_rel)
        np.add.at(Gn, (i, j), ww * np.swapaxes(R_rel, -1, -2))
        G = Gn.transpose(0, 2, 1, 3).reshape(3 * F, 3 * F)
        _, vecs = np.linalg.eigh(G)
        V = vecs[:, -3:].reshape(F, 3, 3)  # block i ~ R_i @ Q
        # all blocks share det sign (det(R_i Q) = det Q); make positive
        sign = np.sign(np.sum(np.sign(np.linalg.det(V))))
        V = V * np.float32(1.0 if sign == 0 else sign)
        u, _, vt = np.linalg.svd(V)        # nearest rotations
        d = np.sign(np.linalg.det(u @ vt))
        D = np.zeros((F, 3, 3), np.float32)
        D[:, 0, 0] = 1.0
        D[:, 1, 1] = 1.0
        D[:, 2, 2] = d
        return (u @ D @ vt).astype(np.float32)

    def residual_deg(R):
        res = np.einsum("ekl,eml->ekm", R[j],
                        np.einsum("ekl,elm->ekm", R_rel, R[i]))
        tr = np.clip((np.trace(res, axis1=-2, axis2=-1) - 1.0) / 2.0,
                     -1.0, 1.0)
        return np.degrees(np.arccos(tr))

    # seed with a maximum-weight spanning tree (Prim: re-pick the
    # heaviest frontier edge after every attachment); edges violently
    # disagreeing with the tree are zeroed before the first solve
    R_tree = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
    visited = np.zeros(F, bool)
    visited[0] = True
    for _ in range(F - 1):
        frontier = visited[i] ^ visited[j]
        if not frontier.any():
            break
        e = np.argmax(np.where(frontier, w0, -1.0))
        a, b = i[e], j[e]
        if visited[a]:
            R_tree[b] = R_rel[e] @ R_tree[a]
            visited[b] = True
        else:
            R_tree[a] = R_rel[e].T @ R_tree[b]
            visited[a] = True
    if visited.all():
        ang0 = residual_deg(R_tree)
        pre = ang0 < 2.0 * huber_deg
        if pre.sum() >= F - 1:
            w0 = np.where(pre, w0, 0.0)  # base weights: IRLS keeps the trim
        w = w0 * huber_deg ** 2 / (huber_deg ** 2 + ang0 ** 2)

    R = solve(w)
    for _ in range(irls_rounds):
        ang = residual_deg(R)
        # Geman-McClure: heavy outliers are crushed, not just damped
        w = w0 * huber_deg ** 2 / (huber_deg ** 2 + ang ** 2)
        R = solve(w)
    # final hard trim of residual outliers, then one clean re-solve
    ang = residual_deg(R)
    keep = ang < 2.0 * huber_deg
    if keep.sum() >= F - 1 and (~keep).any():
        R = solve(np.where(keep, w, 0.0))
    return R


def translation_recovery(edges_ij: np.ndarray, t_dir_w: np.ndarray,
                         weights: np.ndarray, n_frames: int) -> np.ndarray:
    """Camera centres from pairwise world-frame direction constraints.

    Each edge gives a unit d with c_i - c_j parallel (and equal in sign)
    to d.  Solved as the joint linear least squares in (c, s) of the
    rows sqrt(w_e) (c_i - c_j - s_e d_e) = 0, gauge c_0 = 0 (its columns
    dropped), the global scale pinned by a penalty row sum_e s_e = E;
    four IRLS rounds reweight each edge by a Huber factor on its
    residual norm.  Returns (F, 3) float64 centres with c_0 = 0 and
    ||c|| = 1 (the monocular gauge).  Host numpy, as in the JAX
    package."""
    F = n_frames
    E = len(edges_ij)
    d = t_dir_w / np.maximum(np.linalg.norm(t_dir_w, axis=-1, keepdims=True),
                             1e-12)
    w0 = np.maximum(np.asarray(weights, np.float64), 0.0)
    i, j = edges_ij[:, 0], edges_ij[:, 1]
    nC = 3 * (F - 1)
    rows3 = np.arange(3 * E).reshape(E, 3)
    w = w0.copy()
    c = np.zeros((F, 3))
    for _ in range(4):
        sw = np.sqrt(w)
        A = np.zeros((3 * E + 1, nC + E))
        b = np.zeros(3 * E + 1)
        for k in range(3):
            rk = rows3[:, k]
            mask_i = i >= 1
            A[rk[mask_i], 3 * (i[mask_i] - 1) + k] = sw[mask_i]
            mask_j = j >= 1
            A[rk[mask_j], 3 * (j[mask_j] - 1) + k] -= sw[mask_j]
            A[rk, nC + np.arange(E)] = -sw * d[:, k]
        scale_w = 10.0 * (sw.max() + 1e-18)
        A[-1, nC:] = scale_w
        b[-1] = scale_w * E
        x = np.linalg.lstsq(A, b, rcond=None)[0]
        c = np.concatenate([np.zeros(3), x[:nC]]).reshape(F, 3)
        s = x[nC:]
        r = np.linalg.norm(c[i] - c[j] - s[:, None] * d, axis=-1)
        mad = np.median(r) + 1e-18
        w = w0 * np.minimum(1.0, 1.5 * mad / np.maximum(r, 1e-18))
    c /= max(np.linalg.norm(c), 1e-18)
    return c


def _triangulate_one(T1, T2, r1, r2):
    return triangulate(T1, T2, r1[None], r2[None])


_triangulate_tracks = torch.func.vmap(_triangulate_one)


class GlobalSfM:
    """``track(frame)`` buffers; the reconstruction runs once, on the
    first :meth:`finalize` (or ``positions()`` / ``trajectory``), and a
    new frame invalidates it.

    Runs on ``device`` (the CUDA card unless the caller asks for the
    CPU).  ``use_kernels`` routes B1, B2, B3 and, up to 32 cameras, B5 /
    B6 through the CUDA kernels (their plain versions on CPU tensors).
    The pairs' RANSAC draws come from a ``torch.Generator`` seeded with
    ``seed``, or, when ``uniforms`` is given, from ``uniforms(chunk)``,
    which returns the ((B, 8), (B, 4)) draws of each pair of a chunk of
    ``pair_chunk`` pairs, in order (the tests replay the JAX package's
    ``split(key)`` then ``split(sub, len(chunk))`` schedule through
    it)."""

    def __init__(self, camera: Camera, max_kps: int = 512,
                 fast_threshold: float = 0.06, min_pair_inliers: int = 30,
                 pair_chunk: int = 32, ransac_B: int = 256,
                 sigma_px: float = 1.0, max_points: int = 4096,
                 max_obs: int = 16, ba_iters: int = 15, seed: int = 0,
                 use_kernels: bool = True, device="cuda",
                 uniforms: Optional[Callable[[int], list]] = None):
        self.device = require_device(device)
        self.camera = camera
        self.max_kps = max_kps
        self.fast_threshold = fast_threshold
        self.min_pair_inliers = min_pair_inliers
        self.pair_chunk = pair_chunk
        self.ransac_B = ransac_B
        # keypoint noise in normalized units; a generous ~1 px sigma is
        # load-bearing for the H / E model selection
        self.sigma = sigma_px / float(camera.fx)
        self.max_points = max_points
        self.max_obs = max_obs
        self.ba_iters = ba_iters
        self.use_kernels = use_kernels
        self.timer = Timer()
        self._uniforms = uniforms
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.frames: List[FrameData] = []
        self.stats: List[dict] = []
        self.ba_costs: List[float] = []   # the last finalize's LM costs
        # the last finalize's global BA problem, as its tracks built it
        self.ba_problem: Optional[BundleProblem] = None
        self._result: Optional[dict] = None

    # -- SLAM contract ----------------------------------------------------
    def track(self, frame: FrameData) -> torch.Tensor:
        self.frames.append(frame)
        self._result = None
        self.stats.append({"buffered": len(self.frames)})
        # a placeholder: poses exist once finalize() has run
        return se3_identity(device=self.device)

    @property
    def timestamps(self) -> List[float]:
        return [fr.timestamp for fr in self.frames]

    def positions(self) -> np.ndarray:
        return self.finalize()["centers"]

    @property
    def trajectory(self) -> List[torch.Tensor]:
        """cam->world pose (7,) per frame, on the device."""
        pose_wc = torch.as_tensor(self.finalize()["pose_wc"],
                                  device=self.device)
        return list(pose_wc)

    def _pair_draws(self, n: int) -> list:
        if self._uniforms is not None:
            return self._uniforms(n)
        return [two_view_draws(self.ransac_B, self._gen, self.device)
                for _ in range(n)]

    # -- pipeline ----------------------------------------------------------
    def finalize(self) -> dict:
        if self._result is not None:
            return self._result
        F = len(self.frames)
        if F < 3:
            raise ValueError("global SfM needs >= 3 frames")
        dev = self.device
        cam = self.camera

        with self.timer.section("sfm/extract"):
            feats = [extract_features(torch.as_tensor(f.image, device=dev),
                                      max_kps=self.max_kps,
                                      threshold=self.fast_threshold,
                                      use_kernels=self.use_kernels)
                     for f in self.frames]
            desc = torch.stack([f.desc for f in feats])
            valid = torch.stack([f.valid for f in feats])
            rays = torch.stack([cam.unproject(f.uv) for f in feats])

        # every pair, in chunks of pair_chunk (the draws' schedule)
        pairs = np.array([(i, j) for i in range(F) for j in range(i + 1, F)],
                         np.int32)
        geoms: List[PairGeometry] = []
        with self.timer.section("sfm/pairs"):
            for s in range(0, len(pairs), self.pair_chunk):
                chunk = pairs[s:s + self.pair_chunk]
                for (i, j), draws in zip(chunk,
                                         self._pair_draws(len(chunk))):
                    geoms.append(pair_geometry(
                        desc[i], valid[i], rays[i], desc[j], valid[j],
                        rays[j], self.sigma, draws, self.ransac_B,
                        self.use_kernels))
            G = PairGeometry(*(torch.stack([getattr(g, f) for g in geoms])
                               .cpu().numpy()
                               for f in PairGeometry._fields))

        keep = G.n_inliers >= self.min_pair_inliers
        edges = pairs[keep]
        if len(edges) < F - 1:
            log.warning("sfm: view graph weak (%d edges for %d frames)",
                        len(edges), F)
        T_rel = G.T_ji[keep]                     # (E, 7) x_j = T * x_i
        w = G.n_inliers[keep].astype(np.float64)
        w = w / w.max()

        with self.timer.section("sfm/rotations"):
            R_rel = quat_to_matrix(torch.from_numpy(T_rel[:, 3:7])).numpy()
            R = rotation_averaging(edges, R_rel, w, F)

        # per-edge translation directions re-derived with the averaged
        # rotations fixed (no planar degeneracy, unlike the two-view t),
        # then world directions: t_ji = R_j (c_i - c_j) => d = R_j^T t
        with self.timer.section("sfm/translations"):
            Rji = np.einsum("ekl,eml->ekm", R[edges[:, 1]], R[edges[:, 0]])
            r1_all = rays.cpu().numpy()                  # (F, K, 3)
            midx = G.match_idx[keep]                     # (E, K)
            mok = G.match_ok[keep]
            x1 = r1_all[edges[:, 0]]                     # (E, K, 3)
            x2 = np.take_along_axis(r1_all[edges[:, 1]],
                                    np.maximum(midx, 0)[..., None], axis=1)
            t_cam, n_support = _edge_directions(
                torch.as_tensor(Rji, device=dev),
                torch.as_tensor(x1, device=dev),
                torch.as_tensor(x2, device=dev),
                torch.as_tensor(mok, device=dev))
            t_cam = t_cam.cpu().numpy()
            d_w = np.einsum("ekl,ek->el", R[edges[:, 1]], t_cam)
            w_t = w * np.maximum(n_support.cpu().numpy(), 1) / np.maximum(
                mok.sum(-1), 1)
            centers = translation_recovery(edges, d_w, w_t, F)

        # world->cam poses: t = -R c
        t = -np.einsum("fkl,fl->fk", R, centers)
        q = matrix_to_quat(torch.from_numpy(R)).numpy()
        poses_cw = np.concatenate([t, q], -1).astype(np.float32)  # (F, 7)

        with self.timer.section("sfm/tracks"):
            problem = self._build_tracks(poses_cw, r1_all, G, pairs, keep)

        points = np.zeros((0, 3))
        with self.timer.section("sfm/global_ba"):
            if problem is not None:
                poses_cw, points = self._global_ba(problem)

        Rw = quat_to_matrix(torch.from_numpy(poses_cw[:, 3:7])).numpy()
        centers = -np.einsum("fkl,fk->fl", Rw, poses_cw[:, :3])
        pose_wc = se3_inverse(torch.from_numpy(poses_cw)).numpy()
        self._result = {
            "pose_cw": poses_cw, "pose_wc": pose_wc, "centers": centers,
            "points": points,
            "n_edges": int(len(edges)), "n_frames": F,
        }
        return self._result

    def _global_ba(self, problem: BundleProblem
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Global BA, then outlier pruning at 5 and 3 sigma (points left
        with fewer than two observations are fixed) and BA again: wrong
        matches that survived the pairwise gates otherwise anchor the
        local minimum.  Returns the (F, 7) world->cam poses and the (P, 3)
        points; the LM costs (first, then the last of each round) are
        kept in ``ba_costs``, the problem as given in ``ba_problem``."""
        self.ba_problem = problem
        use_k = resolve_ba_kernels(self.use_kernels,
                                   problem.cam_pose.shape[0])
        problem, st = bundle_adjust(problem, iters=self.ba_iters,
                                    use_kernels=use_k)
        n0 = int(problem.obs_valid.sum())
        costs = [st.cost[0], st.cost[-1]]
        for k_sig in (5.0, 3.0):
            errs, evalid = reprojection_errors(problem)
            keep = problem.obs_valid & evalid & (errs < k_sig * self.sigma)
            problem = problem._replace(
                obs_valid=keep,
                point_fixed=problem.point_fixed | (keep.sum(-1) < 2))
            problem, st = bundle_adjust(problem, iters=self.ba_iters,
                                        use_kernels=use_k)
            costs.append(st.cost[-1])
        self.ba_costs = torch.stack(costs).tolist()
        log.info("sfm: global BA cost %s (%d/%d obs kept)",
                 " -> ".join("%.3g" % c for c in self.ba_costs),
                 int(problem.obs_valid.sum()), n0)
        return problem.cam_pose.cpu().numpy(), \
            problem.point_xyz.cpu().numpy()

    # -- tracks + BA problem ------------------------------------------------
    def _build_tracks(self, poses_cw: np.ndarray, rays_np: np.ndarray,
                      G: PairGeometry, pairs: np.ndarray,
                      keep: np.ndarray) -> Optional[BundleProblem]:
        """Union-find track building over the inlier matches (host), then
        two-view triangulation of each track from its first and last
        observation into a BundleProblem on the device."""
        F, K = rays_np.shape[0], rays_np.shape[1]
        parent = np.arange(F * K)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        midx, mok = G.match_idx, G.match_ok
        for e in np.nonzero(keep)[0]:
            i, j = pairs[e]
            for ki in np.nonzero(mok[e])[0]:
                a, b = find(i * K + ki), find(j * K + int(midx[e, ki]))
                if a != b:
                    parent[a] = b
        roots = np.fromiter((find(a) for a in range(F * K)), np.int64)
        uniq, inv, cnt = np.unique(roots, return_inverse=True,
                                   return_counts=True)
        good = cnt >= 2
        track_of = np.where(good[inv], inv, -1)

        # per-track observations (frame, kp), bounded
        order = np.argsort(track_of, kind="stable")
        ordered = track_of[order]
        tids = np.unique(ordered[ordered >= 0])
        if len(tids) == 0:
            return None
        P = min(len(tids), self.max_points)
        O = self.max_obs
        obs_cam = np.zeros((P, O), np.int32)
        obs_kp = np.zeros((P, O), np.int32)
        obs_n = np.zeros(P, np.int32)
        remap = {int(t): n for n, t in enumerate(tids[:P])}
        for node in order[ordered >= 0]:
            t = remap.get(int(track_of[node]))
            if t is None or obs_n[t] >= O:
                continue
            obs_cam[t, obs_n[t]] = node // K
            obs_kp[t, obs_n[t]] = node % K
            obs_n[t] += 1
        valid = np.arange(O)[None, :] < obs_n[:, None]

        uv = rays_np[obs_cam, obs_kp, :2]        # (P, O, 2) normalized
        # triangulate from the two extreme observations
        first = np.zeros(P, np.int32)
        last = np.maximum(obs_n - 1, 0)
        rows = np.arange(P)
        dev = self.device
        Tp = torch.as_tensor(poses_cw, device=dev)
        Xw, depth = _triangulate_tracks(
            Tp[torch.as_tensor(obs_cam[rows, first], device=dev).long()],
            Tp[torch.as_tensor(obs_cam[rows, last], device=dev).long()],
            torch.as_tensor(uv[rows, first], device=dev),
            torch.as_tensor(uv[rows, last], device=dev))
        Xw = Xw[:, 0].cpu().numpy()
        depth = depth[:, 0].cpu().numpy()
        # gate points triangulated at or near infinity (tiny parallax):
        # finite but huge coordinates overflow float32 normal equations
        pt_ok = (np.isfinite(Xw).all(-1) & (depth > 1e-3)
                 & (np.linalg.norm(Xw, axis=-1) < 1e4) & (obs_n >= 2))
        valid &= pt_ok[:, None]
        cam_fixed = np.zeros(len(poses_cw), bool)
        cam_fixed[0] = True

        def on(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        return BundleProblem(
            cam_pose=on(poses_cw), cam_fixed=on(cam_fixed),
            point_xyz=on(np.where(pt_ok[:, None], Xw, 0.0)
                         .astype(np.float32)),
            point_fixed=on(~pt_ok), obs_cam=on(obs_cam),
            obs_uv=on(uv.astype(np.float32)), obs_valid=on(valid),
            obs_weight=on(valid.astype(np.float32)))


@SLAMS.register("sfm")
def _make_sfm(camera: Camera, **kw) -> GlobalSfM:
    kw.pop("vocabulary", None)      # no BoW stage
    return GlobalSfM(camera, **kw)
