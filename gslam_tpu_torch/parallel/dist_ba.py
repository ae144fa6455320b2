"""Distributed Schur-complement bundle adjustment over ``torch.distributed``.

Counterpart of ``gslam_tpu/parallel/dist_ba.py``, the same math step for
step; each rank runs one process of the mesh (``parallel/mesh.py``):

* :func:`distributed_bundle_adjust`, the psum variant: landmarks and
  their padded observation slots are sharded over the 'pt' axis,
  observation slots also over 'obs'; each rank forms its partial reduced
  camera system with :func:`gslam_tpu_torch.opt.ba.schur_partials` (the
  per-point pieces summed over 'obs' before the Hpp inversion), the
  partials are ``all_reduce``d (Hcc, bc and the cost over the mesh,
  S_corr and b_corr over 'pt'), every rank solves the same (6C, 6C)
  system, and landmarks back-substitute where they live.  Plain
  PyTorch, as the reference's is ``jnp``.
* :func:`distributed_bundle_adjust_ring`: the camera state is sharded
  too, and every exchange is a neighbour send / receive
  (``batch_isend_irecv``) around a ring: camera blocks all-gather by
  circulating, and the payload ``[S_corr | Hcc | bvec]`` (6C, 6C + 7)
  moves by reduce-scatter over its camera-block rows and then an
  all-gather of the summed rows.  ``use_kernels=True`` forms each
  shard's pieces with B5's partials entry and its cost with B6
  (:mod:`gslam_tpu_torch.ops.cuda.schur`), the reference's
  ``backend="pallas"``.

Both return the whole problem and the cost history on every rank, as
JAX's global arrays are.  Every rank takes the same LM decisions: a sum
that decides them is formed in rank order on every rank, and the summed
system is the same bits everywhere (one owner sums, the others copy).
A gloo group moves CUDA tensors through the host (gloo's send and recv
take CPU tensors); the compute stays on the card.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gslam_tpu_torch.core.se3 import se3_exp, se3_mul
from gslam_tpu_torch.opt.ba import (
    BundleProblem, assemble_schur, ba_cost, schur_partials, schur_wt_dxc,
)
from gslam_tpu_torch.parallel.mesh import axis_size

ring_hops = 0   # neighbour exchanges of the ring variant since the last reset


def _pad_to(x: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


def _solve_spd(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """-(S + 1e-8 I)^-1 b by Cholesky; NaN where S is not positive
    definite (as ``cho_solve`` gives), with no host read."""
    eye = 1e-8 * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    L, info = torch.linalg.cholesky_ex(S + eye)
    dx = -torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, dx, torch.full_like(dx, float("nan")))


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks (a new tensor)."""
    buf = t.cpu() if _staged(t, group) else t.clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated in rank order."""
    src = t.contiguous().cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def _psum_many(ts: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Several tensors summed over ``group`` in one all_reduce."""
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in ts]), group)
    out, k = [], 0
    for t in ts:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return out


def distributed_bundle_adjust(problem: BundleProblem, mesh: DeviceMesh,
                              iters: int = 10, lm_lambda0: float = 1e-4,
                              huber_delta: float = 0.01
                              ) -> Tuple[BundleProblem, torch.Tensor]:
    """LM BA with the Schur reduction distributed over ``mesh`` (axes
    'pt' and 'obs'); every rank of the mesh calls it with the same
    problem.  P is padded to a multiple of the 'pt' size, O to one of
    the 'obs' size; pads are fixed and observation-less.  Returns (the
    updated problem, the per-iteration costs (iters + 1,)), the same on
    every rank."""
    n_pt, n_obs = axis_size(mesh, "pt"), axis_size(mesh, "obs")
    i_pt, i_obs = mesh.get_local_rank("pt"), mesh.get_local_rank("obs")
    g_pt, g_obs = mesh.get_group("pt"), mesh.get_group("obs")
    C = problem.cam_pose.shape[0]
    P_orig = problem.point_xyz.shape[0]
    dev = problem.cam_pose.device

    def pad_obs(x):
        return _pad_to(_pad_to(x, 0, n_pt), 1, n_obs)

    point_xyz = _pad_to(problem.point_xyz, 0, n_pt)
    P_pad = point_xyz.shape[0]
    pad_mask = torch.arange(P_pad, device=dev) >= P_orig
    point_fixed = _pad_to(problem.point_fixed, 0, n_pt) | pad_mask
    obs_valid = pad_obs(problem.obs_valid) & ~pad_mask[:, None]
    Pl, Ol = P_pad // n_pt, obs_valid.shape[1] // n_obs
    ps = slice(i_pt * Pl, (i_pt + 1) * Pl)
    os_ = slice(i_obs * Ol, (i_obs + 1) * Ol)
    obs_cam = pad_obs(problem.obs_cam)[ps, os_]
    obs_uv = pad_obs(problem.obs_uv)[ps, os_]
    obs_weight = pad_obs(problem.obs_weight)[ps, os_]
    obs_valid = obs_valid[ps, os_]
    point_fixed = point_fixed[ps]
    point_xyz = point_xyz[ps]
    cam_free = ~problem.cam_fixed
    pt_free = ~point_fixed

    def local(cam_pose, xyz):
        return BundleProblem(cam_pose, problem.cam_fixed, xyz, point_fixed,
                             obs_cam, obs_uv, obs_valid, obs_weight)

    def cost_of(cam_pose, xyz):
        return all_reduce_sum(ba_cost(local(cam_pose, xyz), huber_delta))

    cam_pose = problem.cam_pose
    lam = torch.full((), lm_lambda0, dtype=torch.float32, device=dev)
    cost = cost_of(cam_pose, point_xyz)
    costs = [cost]
    for _ in range(iters):
        # per-point pieces complete over 'obs' inside (the Hpp inversion
        # and the Schur cross terms need whole points)
        Hcc_l, bc_l, S_l, bcorr_l, W, Hpp_inv, bp = schur_partials(
            local(cam_pose, point_xyz), lam, huber_delta, n_cams=C,
            obs_psum=lambda x: all_reduce_sum(x, g_obs))
        # camera partials over the whole mesh; the 'obs' ranks of a
        # point block hold the same W, so S_corr and b_corr sum over 'pt'
        Hcc, bc = _psum_many([Hcc_l, bc_l])
        S_corr, b_corr = _psum_many([S_l, bcorr_l], g_pt)
        S, b_s = assemble_schur(Hcc, bc * cam_free[:, None] - b_corr,
                                S_corr, lam, cam_free)
        dxc = _solve_spd(S, b_s).reshape(C, 6) * cam_free[:, None]
        # W^T dxc spans every observation slot of a point: sum over 'obs'
        Wt_dxc = all_reduce_sum(schur_wt_dxc(W, dxc.reshape(-1)), g_obs)
        dxp = -torch.einsum("pab,pb->pa", Hpp_inv, bp + Wt_dxc)
        dxp = dxp * pt_free[:, None]
        new_pose = se3_mul(se3_exp(dxc), cam_pose)
        new_xyz = point_xyz + dxp
        new_cost = cost_of(new_pose, new_xyz)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        cam_pose = torch.where(accept, new_pose, cam_pose)
        point_xyz = torch.where(accept, new_xyz, point_xyz)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e3)
        costs.append(cost)
    points = all_gather_cat(point_xyz, g_pt)[:P_orig]
    return (problem._replace(cam_pose=cam_pose, point_xyz=points),
            torch.stack(costs))


def ring_shard(problem: BundleProblem, n: int, i: int) -> BundleProblem:
    """What rank ``i`` of a ring of ``n`` holds of ``problem``: every
    camera, C padded to a multiple of n with fixed identity poses, and
    its contiguous block of the points, P padded to a multiple of n with
    fixed points without observations."""
    C, P = problem.cam_pose.shape[0], problem.point_xyz.shape[0]
    dev = problem.cam_pose.device
    cam_pose = _pad_to(problem.cam_pose, 0, n).clone()
    cam_pose[C:, 3] = 1.0
    C_pad = cam_pose.shape[0]
    P_pad = -(-P // n) * n
    pad_pt = torch.arange(P_pad, device=dev) >= P
    ps = slice(i * (P_pad // n), (i + 1) * (P_pad // n))

    def block(x):
        return _pad_to(x, 0, n)[ps]

    return BundleProblem(
        cam_pose=cam_pose,
        cam_fixed=_pad_to(problem.cam_fixed, 0, n)
        | (torch.arange(C_pad, device=dev) >= C),
        point_xyz=block(problem.point_xyz),
        point_fixed=block(problem.point_fixed) | pad_pt[ps],
        obs_cam=block(problem.obs_cam), obs_uv=block(problem.obs_uv),
        obs_valid=block(problem.obs_valid) & ~pad_pt[ps, None],
        obs_weight=block(problem.obs_weight))


class _Ring:
    """Neighbour exchanges around the ranks of ``group`` in rank order:
    each sends to the next rank and receives from the previous one."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.i = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.i + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.i - 1) % self.n)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send ``x`` one hop right; return what arrives from the left."""
        global ring_hops
        send = x.contiguous()
        if _staged(send, self.group):
            send = send.cpu()
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, self.next, self.group),
                dist.P2POp(dist.irecv, recv, self.prev, self.group)]):
            req.wait()
        ring_hops += 1
        return recv.to(x.device)

    def allgather(self, blk: torch.Tensor) -> torch.Tensor:
        """Every rank's block, in rank order, by n - 1 hops: each hop
        moves every block one rank to the right."""
        parts = [None] * self.n
        owner = self.i
        for k in range(self.n):
            parts[owner] = blk
            if k < self.n - 1:
                blk = self.shift(blk)
                owner = (owner - 1) % self.n
        return torch.cat(parts)

    def sum_scalar(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a 0-d ``x`` over the ranks, formed in rank order on
        every rank, so that every rank has the same bits."""
        vals = self.allgather(x.reshape(1))
        acc = vals[0]
        for k in range(1, self.n):
            acc = acc + vals[k]
        return acc

    def reduce_scatter_rows(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """This rank's ``rows`` rows of ``x`` summed over the ranks: chunk
        c starts at rank c + 1 and hops right, each rank adding its own
        part; after n - 1 hops it is home and complete.  Each hop carries
        one chunk."""
        def chunk(c):
            return x[c * rows:(c + 1) * rows]

        acc = chunk((self.i - 1) % self.n)
        for t in range(1, self.n):
            acc = self.shift(acc) + chunk((self.i - 1 - t) % self.n)
        return acc


def distributed_bundle_adjust_ring(problem: BundleProblem, mesh: DeviceMesh,
                                   iters: int = 10, lm_lambda0: float = 1e-4,
                                   huber_delta: float = 0.01,
                                   use_kernels: bool = False
                                   ) -> Tuple[BundleProblem, torch.Tensor]:
    """Ring-exchange variant of :func:`distributed_bundle_adjust` on a
    1-D mesh (axis 'pt'): each rank owns a contiguous block of C / n
    cameras and of the points (C and P padded to multiples of n; pad
    cameras have the identity pose and are fixed), and moves data only
    by neighbour exchanges (:class:`_Ring`, counted in ``ring_hops``).
    Per LM step: the cameras all-gather, each rank forms its shard's
    pieces (B5's partials entry with ``use_kernels``), the payload
    ``[S_corr | Hcc | bvec]`` reduce-scatters over camera-block rows
    and all-gathers, and every rank damps, pins and solves the same
    system.  Returns (problem, costs) as the psum variant does."""
    ring = _Ring(mesh.get_group("pt"))
    n, i = ring.n, ring.i
    C = problem.cam_pose.shape[0]
    P_orig = problem.point_xyz.shape[0]
    dev = problem.cam_pose.device
    shard = ring_shard(problem, n, i)
    C_pad = shard.cam_pose.shape[0]
    Cl = C_pad // n
    cam_free = ~shard.cam_fixed
    pt_free = ~shard.point_fixed

    if use_kernels:
        from gslam_tpu_torch.ops.cuda.schur import (
            ba_cost_kernel, schur_partials_kernel,
        )
        cost_fn = ba_cost_kernel
    else:
        cost_fn = ba_cost

    def local(cam_full, xyz):
        return shard._replace(cam_pose=cam_full, point_xyz=xyz)

    def cost_of(cam_block, xyz):
        return ring.sum_scalar(cost_fn(local(ring.allgather(cam_block), xyz),
                                       huber_delta))

    def pieces(cam_full, xyz, lam):
        """(Hcc, bvec, S_corr, W, Hpp_inv, bp) of this rank's points."""
        if use_kernels:
            return schur_partials_kernel(local(cam_full, xyz), lam,
                                         huber_delta)
        Hcc, bc, S_corr, b_corr, W, Hpp_inv, bp = schur_partials(
            local(cam_full, xyz), lam, huber_delta, n_cams=C_pad)
        return Hcc, bc - b_corr, S_corr, W, Hpp_inv, bp

    cam_block = shard.cam_pose[i * Cl:(i + 1) * Cl]
    point_xyz = shard.point_xyz
    lam = torch.full((), lm_lambda0, dtype=torch.float32, device=dev)
    cost = cost_of(cam_block, point_xyz)
    costs = [cost]
    for _ in range(iters):
        cam_full = ring.allgather(cam_block)
        Hcc_l, bvec_l, S_l, W, Hpp_inv, bp = pieces(cam_full, point_xyz, lam)
        payload = torch.cat([S_l, Hcc_l.reshape(C_pad * 6, 6),
                             bvec_l.reshape(C_pad * 6, 1)], 1)
        full = ring.allgather(ring.reduce_scatter_rows(payload, 6 * Cl))
        S_corr = full[:, :6 * C_pad]
        Hcc = full[:, 6 * C_pad:6 * C_pad + 6].reshape(C_pad, 6, 6)
        bvec = full[:, 6 * C_pad + 6].reshape(C_pad, 6)
        # damping and pinning after the cross-shard sum
        S, b_s = assemble_schur(Hcc, bvec * cam_free[:, None], S_corr, lam,
                                cam_free)
        dxc = _solve_spd(S, b_s).reshape(C_pad, 6) * cam_free[:, None]
        dxp = -torch.einsum("pab,pb->pa", Hpp_inv,
                            bp + schur_wt_dxc(W, dxc.reshape(-1)))
        dxp = dxp * pt_free[:, None]
        new_block = se3_mul(se3_exp(dxc), cam_full)[i * Cl:(i + 1) * Cl]
        new_xyz = point_xyz + dxp
        new_cost = cost_of(new_block, new_xyz)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        cam_block = torch.where(accept, new_block, cam_block)
        point_xyz = torch.where(accept, new_xyz, point_xyz)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e3)
        costs.append(cost)
    points = ring.allgather(point_xyz)[:P_orig]
    cams = ring.allgather(cam_block)[:C]
    return (problem._replace(cam_pose=cams, point_xyz=points),
            torch.stack(costs))
