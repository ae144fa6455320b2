"""Pose-graph optimization over SE3 or SIM3 (the loop-closure backend).

Counterpart of ``gslam_tpu/opt/pose_graph.py``.  Residual per edge
(i, j): r = log(Z_ij^-1 * T_i * T_j^-1) in the tangent (6 for SE3, 7 for
SIM3).  The Jacobians wrt the left-multiplicative tangents of T_i and
T_j are forward-mode derivatives at zero (``torch.func.jacfwd``): one
shared tangent is applied to every edge, and since an edge's residual
depends only on its own copy, the (E, d, 2d) result holds each edge's
two blocks.  Damped Gauss-Newton runs a fixed count of steps with the
accept test as a device mask: nothing inside reads a value back to the
host.  Gauge freedom is removed by the ``fixed`` mask (typically node
0).

Sums over edges (``.at[].add`` in the JAX package) are
``index_put_(accumulate=True)``, which on the card sorts the indices and
adds each slot's updates in edge order: the same bits from run to run,
where ``index_add_``'s float atomics are not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gslam_tpu_torch.core import se3, sim3
from gslam_tpu_torch.core.so3 import quat_conj, quat_rotate


class PoseGraph(NamedTuple):
    poses: torch.Tensor       # (N, 7) SE3 or (N, 8) SIM3
    fixed: torch.Tensor       # (N,) bool
    edge_i: torch.Tensor      # (E,) int32
    edge_j: torch.Tensor      # (E,) int32
    edge_rel: torch.Tensor    # (E, 7|8) measured Z_ij ~= T_i * T_j^-1
    edge_valid: torch.Tensor  # (E,) bool
    edge_weight: torch.Tensor  # (E,) scalar information, or (E, d)
    #   per-residual-dim diagonal information (anisotropic odometry,
    #   rotation-only edges)
    # optional unary position priors (GPS; metres on the camera centre)
    prior_pos: Optional[torch.Tensor] = None     # (N, 3)
    prior_weight: Optional[torch.Tensor] = None  # (N,) 0 = no prior


class _Group(NamedTuple):
    mul: callable
    inv: callable
    exp: callable
    log: callable
    dim: int


def _group_ops(mode: str) -> _Group:
    if mode == "se3":
        return _Group(se3.se3_mul, se3.se3_inverse, se3.se3_exp,
                      se3.se3_log, 6)
    if mode == "sim3":
        return _Group(sim3.sim3_mul, sim3.sim3_inverse, sim3.sim3_exp,
                      sim3.sim3_log, 7)
    raise ValueError(f"mode must be se3|sim3, got {mode}")


def _edge_info(weight: torch.Tensor, d: int) -> torch.Tensor:
    """(E,) scalar or (E, d) diagonal information -> (E, d)."""
    if weight.dim() == 1:
        return weight[:, None].expand(weight.shape[0], d)
    return weight


def _cam_center(poses: torch.Tensor) -> torch.Tensor:
    """Camera centres (N, 3) of world->cam poses: c = -R^T t."""
    return -quat_rotate(quat_conj(poses[..., 3:7]), poses[..., :3])


def _add_rows(out: torch.Tensor, idx: torch.Tensor, val: torch.Tensor
              ) -> torch.Tensor:
    """``out.at[idx].add(val)`` in place, deterministic on the card."""
    return out.index_put_((idx,), val, accumulate=True)


def pose_graph_cost(g: PoseGraph, mode: str = "se3") -> torch.Tensor:
    ops = _group_ops(mode)
    Ti = g.poses[g.edge_i.long()]
    Tj = g.poses[g.edge_j.long()]
    r = ops.log(ops.mul(ops.inv(g.edge_rel), ops.mul(Ti, ops.inv(Tj))))
    r2 = torch.sum(r * r * _edge_info(g.edge_weight, ops.dim), -1)
    cost = torch.where(g.edge_valid, r2, torch.zeros_like(r2)).sum()
    if g.prior_pos is not None:
        pr = _cam_center(g.poses) - g.prior_pos
        cost = cost + torch.sum(g.prior_weight * torch.sum(pr * pr, -1))
    return cost


def _edge_residual(ops: _Group, xi, xj, Ti, Tj, Z):
    Ti_p = ops.mul(ops.exp(xi), Ti)
    Tj_p = ops.mul(ops.exp(xj), Tj)
    return ops.log(ops.mul(ops.inv(Z), ops.mul(Ti_p, ops.inv(Tj_p))))


def linearize(g: PoseGraph, poses: torch.Tensor, mode: str = "se3"):
    """Edge and prior linearization at ``poses``: r (E, d), the weighted
    and free-masked Jacobians Jiw / Jjw and the free-masked Ji / Jj
    (E, d, d), the block-diagonal prior Hessian Hp (N, d, d), and the
    gradient b (N, d) with fixed rows zeroed."""
    ops = _group_ops(mode)
    d = ops.dim
    N = poses.shape[0]
    free = ~g.fixed
    ei, ej = g.edge_i.long(), g.edge_j.long()
    Ti, Tj = poses[ei], poses[ej]
    zero2 = poses.new_zeros(2 * d)
    r = _edge_residual(ops, zero2[:d], zero2[d:], Ti, Tj, g.edge_rel)
    J = torch.func.jacfwd(lambda x: _edge_residual(
        ops, x[:d], x[d:], Ti, Tj, g.edge_rel))(zero2)      # (E, d, 2d)
    w = (g.edge_valid[:, None] * _edge_info(g.edge_weight, d))[:, :, None]
    Ji = J[..., :d] * free[ei][:, None, None]
    Jj = J[..., d:] * free[ej][:, None, None]
    Jiw = Ji * w
    Jjw = Jj * w
    b = poses.new_zeros((N, d))
    _add_rows(b, ei, torch.einsum("eab,ea->eb", Jiw, r))
    _add_rows(b, ej, torch.einsum("eab,ea->eb", Jjw, r))
    Hp = poses.new_zeros((N, d, d))
    if g.prior_pos is not None:
        # unary prior on the camera centres: residual c(T) - pos
        Jp = torch.func.jacfwd(lambda x: _cam_center(
            ops.mul(ops.exp(x), poses)))(zero2[:d])          # (N, 3, d)
        rp = _cam_center(poses) - g.prior_pos
        wp = (g.prior_weight * free)[:, None, None]
        Hp = torch.einsum("nab,nac->nbc", Jp * wp, Jp)
        b = b + torch.einsum("nab,na->nb", Jp * wp, rp)
    b = b * free[:, None]
    return r, Jiw, Jjw, Ji, Jj, Hp, b


def _solve_dense(g: PoseGraph, lin, lam: torch.Tensor) -> torch.Tensor:
    """Assemble the (N d, N d) normal matrix and LU-solve it.  LU, not
    Cholesky: the damped H is SPD in exact arithmetic but spans about 12
    decades in float32, where Cholesky breaks down on loop-closure
    graphs.  A singular H gives a non-finite step (no exception)."""
    _, Jiw, Jjw, Ji, Jj, Hp, b = lin
    N, d = b.shape
    free = ~g.fixed
    ei, ej = g.edge_i.long(), g.edge_j.long()
    H = b.new_zeros((N, N, d, d))
    H.index_put_((ei, ei), torch.einsum("eab,eac->ebc", Jiw, Ji),
                 accumulate=True)
    H.index_put_((ej, ej), torch.einsum("eab,eac->ebc", Jjw, Jj),
                 accumulate=True)
    H.index_put_((ei, ej), torch.einsum("eab,eac->ebc", Jiw, Jj),
                 accumulate=True)
    H.index_put_((ej, ei), torch.einsum("eab,eac->ebc", Jjw, Ji),
                 accumulate=True)
    nn = torch.arange(N, device=b.device)
    H[nn, nn] += Hp
    Hd = H.permute(0, 2, 1, 3).reshape(N * d, N * d)
    boost = torch.where(free.repeat_interleave(d), lam,
                        torch.ones_like(lam))
    Hd = Hd + torch.diag(boost + 1e-10)
    x = torch.linalg.solve_ex(Hd, b.reshape(-1, 1))[0]
    return -x.reshape(N, d)


def _solve_pcg(g: PoseGraph, lin, lam: torch.Tensor, K_cg: int
               ) -> torch.Tensor:
    """Matrix-free block-Jacobi PCG on (H + damping) dx = -b: Hx products
    are two gathers, batched (d, d) products and two edge-list sums; the
    preconditioner is the per-node (d, d) diagonal block's Cholesky
    factor.  ``K_cg`` steps with a convergence mask on the device."""
    _, Jiw, Jjw, Ji, Jj, Hp, b = lin
    N, d = b.shape
    free = ~g.fixed
    ei, ej = g.edge_i.long(), g.edge_j.long()
    diagvec = torch.where(free, lam, torch.ones_like(lam))[:, None] + 1e-10

    def hvp(x):
        y = (torch.einsum("eab,eb->ea", Ji, x[ei])
             + torch.einsum("eab,eb->ea", Jj, x[ej]))   # residual space
        z = b.new_zeros((N, d))
        _add_rows(z, ei, torch.einsum("eab,ea->eb", Jiw, y))
        _add_rows(z, ej, torch.einsum("eab,ea->eb", Jjw, y))
        return z + torch.einsum("nbc,nc->nb", Hp, x) + x * diagvec

    blk = b.new_zeros((N, d, d))
    _add_rows(blk, ei, torch.einsum("eab,eac->ebc", Jiw, Ji))
    _add_rows(blk, ej, torch.einsum("eab,eac->ebc", Jjw, Jj))
    # scale-aware jitter: the blocks are SPD but can span about 7 decades
    # in float32; any SPD M is a valid preconditioner
    tr = torch.diagonal(blk, dim1=1, dim2=2).sum(-1)[:, None, None]
    blk = blk + Hp + (diagvec[:, :, None] + 1e-5 * tr / d) \
        * torch.eye(d, dtype=b.dtype, device=b.device)[None]
    L_blk, info = torch.linalg.cholesky_ex(blk)
    # a failed factor gives NaN, as jnp.linalg.cholesky does
    L_blk = torch.where((info == 0)[:, None, None], L_blk,
                        torch.full_like(L_blk, float("nan")))

    def minv(x):
        return torch.cholesky_solve(x[..., None], L_blk)[..., 0]

    rhs = -b
    x = torch.zeros_like(b)
    res = rhs
    z = minv(res)
    p = z
    rz = torch.sum(res * z)
    tol2 = 1e-12 * torch.sum(rhs * rhs).clamp_min(1e-30)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    for _ in range(K_cg):
        Ap = hvp(p)
        alpha = rz / torch.sum(p * Ap).clamp_min(1e-30)
        x1 = x + alpha * p
        res1 = res - alpha * Ap
        z1 = minv(res1)
        rz1 = torch.sum(res1 * z1)
        p1 = z1 + (rz1 / rz.clamp_min(1e-30)) * p
        conv = torch.sum(res1 * res1) < tol2
        x = torch.where(done, x, x1)
        res = torch.where(done, res, res1)
        p = torch.where(done, p, p1)
        rz = torch.where(done, rz, rz1)
        done = done | conv
    return x


def optimize_pose_graph(g: PoseGraph, mode: str = "se3", iters: int = 20,
                        lm_lambda0: float = 1e-6, solver: str = "auto",
                        cg_iters: int = 0
                        ) -> Tuple[PoseGraph, torch.Tensor]:
    """Damped Gauss-Newton; returns (graph, per-iteration costs
    (iters + 1,)).

    solver:
      "dense": assemble the (N d, N d) normal matrix, LU solve; right up
        to a few hundred nodes.
      "pcg": matrix-free block-Jacobi preconditioned CG, O(E d^2) memory.
      "auto": dense while N d <= 1536 (256 SE3 nodes), else pcg.
    cg_iters: CG steps per GN step (0 = min(N d, 128)); converged steps
      are masked.
    """
    ops = _group_ops(mode)
    d = ops.dim
    N = g.poses.shape[0]
    free = ~g.fixed
    if solver not in ("auto", "dense", "pcg"):
        raise ValueError(f"solver must be auto|dense|pcg, got {solver}")
    use_pcg = solver == "pcg" or (solver == "auto" and N * d > 1536)
    K_cg = cg_iters if cg_iters > 0 else min(N * d, 128)

    poses = g.poses
    lam = torch.full((), lm_lambda0, dtype=torch.float32,
                     device=poses.device)
    cost = pose_graph_cost(g, mode)
    costs = [cost]
    for _ in range(iters):
        lin = linearize(g, poses, mode)
        dx = _solve_pcg(g, lin, lam, K_cg) if use_pcg \
            else _solve_dense(g, lin, lam)
        dx = dx * free[:, None]
        new_poses = ops.mul(ops.exp(dx), poses)
        new_cost = pose_graph_cost(g._replace(poses=new_poses), mode)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        poses = torch.where(accept, new_poses, poses)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.5, lam * 8.0).clamp(1e-9, 1e6)
        costs.append(cost)
    return g._replace(poses=poses), torch.stack(costs)
