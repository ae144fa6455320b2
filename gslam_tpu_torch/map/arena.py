"""Fixed-capacity SoA map arena and its insert / erase / query operations.

Counterpart of ``gslam_tpu/map/arena.py``: every store is a fixed-size
tensor with a validity mask, an id is its slot, observations are a flat
(frame, point, keypoint) edge list, and the covisibility graph is the
Gram matrix of the frame x point incidence matrix.  Capacities are
Python ints; overflow drops writes and raises the ``overflow`` flag.

Scatter rules.  JAX drops out-of-range scatters, clamps gathers, and on
its CPU backend a scatter with repeated indices keeps the LAST update.
The functions here reproduce those results deterministically and without
host syncs: :func:`set_rows` lets the last writer of each slot win by
giving every writer of a slot the winner's value (so the order in which
the card applies duplicates cannot matter), integer ``.at[].add`` /
``.at[].min`` become ``index_add`` / ``scatter_reduce``, and the stable
``argsort(~valid)`` compactions sort an integer key with
``stable=True``.  Descriptors are int32 tensors carrying the uint32 bit
pattern.  Nothing here reads a value back to the host, except
:func:`arena_stats`, :func:`save_arena` and :func:`merge_arenas` (one read
of the counters).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gslam_tpu_torch.core.se3 import se3_inverse
from gslam_tpu_torch.ops.frontend import DESC_WORDS
from gslam_tpu_torch.utils.platform import require_device

_CAPS = ("cap_frames", "cap_kps", "cap_points", "cap_obs")
INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class MapArena:
    """The whole SLAM world state (shapes as in the JAX ``MapArena``):

    frames: pose (F, 8) Sim3 [t, q, s]; time (F,); valid; flags; camera;
    kp uv (F, K, 2); kp meta (F, K, 4); kp depth (F, K); descriptors
    (F, K, 8) int32 words; kp_count (F,).  points: xyz, normal, color
    (P, 3); descriptor (P, 8); valid; ref_frame; visible; found.  obs:
    frame, point, kp, valid (E,).  counters: 0-d n_frames, n_points,
    n_obs (int32) and overflow (bool).  Capacities are Python ints.
    """

    frame_pose: torch.Tensor
    frame_time: torch.Tensor
    frame_valid: torch.Tensor
    frame_flags: torch.Tensor
    frame_camera: torch.Tensor
    frame_kp_uv: torch.Tensor
    frame_kp_meta: torch.Tensor
    frame_kp_depth: torch.Tensor
    frame_desc: torch.Tensor
    frame_kp_count: torch.Tensor
    point_xyz: torch.Tensor
    point_normal: torch.Tensor
    point_color: torch.Tensor
    point_desc: torch.Tensor
    point_valid: torch.Tensor
    point_ref_frame: torch.Tensor
    point_visible: torch.Tensor
    point_found: torch.Tensor
    obs_frame: torch.Tensor
    obs_point: torch.Tensor
    obs_kp: torch.Tensor
    obs_valid: torch.Tensor
    n_frames: torch.Tensor
    n_points: torch.Tensor
    n_obs: torch.Tensor
    overflow: torch.Tensor
    cap_frames: int
    cap_kps: int
    cap_points: int
    cap_obs: int

    def replace(self, **kw) -> "MapArena":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.point_xyz.device

    def tensors(self):
        """(name, tensor) pairs of every field that is not a capacity."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self) if f.name not in _CAPS]


def make_arena(cap_frames: int = 256, cap_kps: int = 512,
               cap_points: int = 16384, cap_obs: int = 65536,
               device="cuda") -> MapArena:
    """An empty arena on ``device`` (the card unless the caller asks
    for the CPU)."""
    dev = require_device(device)
    F, K, P, E = cap_frames, cap_kps, cap_points, cap_obs
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    pose0 = z(F, 8)
    pose0[:, 3] = 1.0
    pose0[:, 7] = 1.0
    return MapArena(
        frame_pose=pose0, frame_time=z(F), frame_valid=z(F, dtype=torch.bool),
        frame_flags=z(F, dtype=i32), frame_camera=z(F, dtype=i32),
        frame_kp_uv=z(F, K, 2), frame_kp_meta=z(F, K, 4),
        frame_kp_depth=z(F, K), frame_desc=z(F, K, DESC_WORDS, dtype=i32),
        frame_kp_count=z(F, dtype=i32),
        point_xyz=z(P, 3), point_normal=z(P, 3), point_color=z(P, 3),
        point_desc=z(P, DESC_WORDS, dtype=i32),
        point_valid=z(P, dtype=torch.bool), point_ref_frame=z(P, dtype=i32),
        point_visible=z(P, dtype=i32), point_found=z(P, dtype=i32),
        obs_frame=z(E, dtype=i32), obs_point=z(E, dtype=i32),
        obs_kp=z(E, dtype=i32), obs_valid=z(E, dtype=torch.bool),
        n_frames=z(dtype=i32), n_points=z(dtype=i32), n_obs=z(dtype=i32),
        overflow=z(dtype=torch.bool),
        cap_frames=F, cap_kps=K, cap_points=P, cap_obs=E)


# ---------------------------------------------------------------------------
# scatter helpers (JAX semantics, deterministic, no host sync)


def set_rows(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor
             ) -> torch.Tensor:
    """``buf.at[idx].set(val)`` with in-range ``idx`` and the last
    update winning where ``idx`` repeats (a new tensor)."""
    idx = idx.long()
    pos = torch.arange(idx.shape[0], device=idx.device)
    win = torch.full((buf.shape[0],), -1, dtype=torch.long,
                     device=idx.device).scatter_reduce(0, idx, pos, "amax")
    out = buf.clone()
    out[idx] = val[win[idx]].to(buf.dtype)
    return out


def edge_slots(point: torch.Tensor, ok: torch.Tensor, P: int, O: int):
    """Lay an edge list out as (P, O) per-point slots: each point keeps
    its first ``O`` edges in edge-list order.  ``point`` (E,) the point
    of each edge, ``ok`` (E,) the edges to keep.  Returns (order,
    ok_sorted, tgt_p, tgt_o): the stable sort of the edges by point, and
    each sorted edge's kept flag and (point, slot) target, the dump row
    ``P`` for an edge that is not kept."""
    E = point.shape[0]
    key = torch.where(ok, point, P)
    order = torch.argsort(key, stable=True)
    pt_sorted = key[order].long()
    pos = torch.arange(E, device=point.device)
    first = torch.full((P + 1,), E, dtype=torch.long, device=point.device) \
        .scatter_reduce(0, pt_sorted, pos, "amin")
    slot = pos - first[pt_sorted]
    ok_sorted = ok[order] & (slot < O)
    tgt_p = torch.where(ok_sorted, pt_sorted, P)
    tgt_o = torch.where(ok_sorted, slot, 0)
    return order, ok_sorted, tgt_p, tgt_o


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _stable_valid_first(valid: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(~valid)``: valid entries first, stable."""
    return torch.argsort((~valid).to(torch.int32), stable=True)


# ---------------------------------------------------------------------------
# insertion


def insert_frame(arena: MapArena, pose: torch.Tensor, time,
                 kp_uv: torch.Tensor, kp_meta: torch.Tensor,
                 desc: torch.Tensor, kp_count: torch.Tensor,
                 kp_depth: Optional[torch.Tensor] = None,
                 camera: int = 0, flags: int = 0
                 ) -> Tuple[MapArena, torch.Tensor]:
    """Insert one frame; returns (arena, frame_id), frame_id -1 and the
    ``overflow`` flag set when the frame store is full."""
    dev = arena.device
    fid = arena.n_frames
    ok = fid < arena.cap_frames
    slot = torch.where(ok, fid, arena.cap_frames - 1).long().reshape(1)
    if kp_depth is None:
        kp_depth = torch.zeros(arena.cap_kps, device=dev)

    def wr(buf, val):
        if isinstance(val, torch.Tensor):
            val = val.to(buf.dtype).expand(buf.shape[1:])
        else:                        # a Python scalar: no host copy
            val = torch.full(buf.shape[1:], val, dtype=buf.dtype, device=dev)
        new = buf.index_copy(0, slot, val[None])
        return torch.where(ok, new, buf)

    arena = arena.replace(
        frame_pose=wr(arena.frame_pose, pose),
        frame_time=wr(arena.frame_time, time),
        frame_valid=wr(arena.frame_valid, True),
        frame_flags=wr(arena.frame_flags, flags),
        frame_camera=wr(arena.frame_camera, camera),
        frame_kp_uv=wr(arena.frame_kp_uv, kp_uv),
        frame_kp_meta=wr(arena.frame_kp_meta, kp_meta),
        frame_kp_depth=wr(arena.frame_kp_depth, kp_depth),
        frame_desc=wr(arena.frame_desc, desc),
        frame_kp_count=wr(arena.frame_kp_count, kp_count),
        n_frames=torch.where(ok, fid + 1, fid),
        overflow=arena.overflow | ~ok)
    return arena, torch.where(ok, fid, torch.full_like(fid, -1))


def insert_points(arena: MapArena, xyz: torch.Tensor, desc: torch.Tensor,
                  valid: torch.Tensor, ref_frame,
                  normal: Optional[torch.Tensor] = None,
                  color: Optional[torch.Tensor] = None
                  ) -> Tuple[MapArena, torch.Tensor]:
    """Batch-insert N candidate points (``valid`` selects the real ones):
    compacted to the front and written contiguously at ``n_points``.
    Returns per-input point ids (-1 where invalid or dropped)."""
    dev = arena.device
    N = xyz.shape[0]
    P = arena.cap_points
    valid = valid.to(torch.bool)
    order = _stable_valid_first(valid)
    ref = torch.as_tensor(ref_frame, dtype=torch.int32, device=dev)
    n_new = valid.sum().to(torch.int32)
    base = arena.n_points
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    want = idx < n_new
    fits = (base + idx) < P
    write = want & fits
    slots = torch.where(write, base + idx, P - 1)

    def scat(buf, val):
        val = val.to(buf.dtype)
        keep = buf[slots.long()]
        return set_rows(buf, slots, torch.where(_expand(write, val), val,
                                                keep))

    zeros3 = torch.zeros_like(xyz)
    zeros_i = torch.zeros(N, dtype=torch.int32, device=dev)
    arena = arena.replace(
        point_xyz=scat(arena.point_xyz, xyz[order]),
        point_desc=scat(arena.point_desc, desc[order]),
        point_normal=scat(arena.point_normal,
                          (zeros3 if normal is None else normal)[order]),
        point_color=scat(arena.point_color,
                         (zeros3 if color is None else color)[order]),
        point_ref_frame=scat(arena.point_ref_frame, ref.expand(N)[order]),
        point_visible=scat(arena.point_visible, zeros_i),
        point_found=scat(arena.point_found, zeros_i),
        point_valid=scat(arena.point_valid, torch.ones_like(valid)),
        n_points=torch.clamp_max(base + n_new, P),
        overflow=arena.overflow | (want & ~fits).any())
    rank = torch.cumsum(valid.to(torch.int32), 0) - 1
    ids = torch.where(valid & ((base + rank) < P), base + rank,
                      torch.full_like(rank, -1))
    return arena, ids.to(torch.int32)


def add_observations(arena: MapArena, frame_id, point_ids: torch.Tensor,
                     kp_ids: torch.Tensor, valid: torch.Tensor) -> MapArena:
    """Append N observation edges (frame, point, kp) where valid."""
    dev = arena.device
    N = point_ids.shape[0]
    E = arena.cap_obs
    valid = valid.to(torch.bool) & (point_ids >= 0)
    order = _stable_valid_first(valid)
    n_new = valid.sum().to(torch.int32)
    base = arena.n_obs
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    want = idx < n_new
    fits = (base + idx) < E
    write = want & fits
    slots = torch.where(write, base + idx, E - 1)

    def scat(buf, val):
        val = val.to(buf.dtype)
        return set_rows(buf, slots, torch.where(write, val, buf[slots.long()]))

    fid = torch.as_tensor(frame_id, dtype=torch.int32, device=dev)
    return arena.replace(
        obs_frame=scat(arena.obs_frame, fid.expand(N)),
        obs_point=scat(arena.obs_point, point_ids[order]),
        obs_kp=scat(arena.obs_kp, kp_ids[order]),
        obs_valid=scat(arena.obs_valid, write),
        n_obs=torch.clamp_max(base + n_new, E),
        overflow=arena.overflow | (want & ~fits).any())


# ---------------------------------------------------------------------------
# erasure


def erase_points(arena: MapArena, point_ids: torch.Tensor) -> MapArena:
    pid = point_ids.clamp_min(0)
    pv = set_rows(arena.point_valid, pid,
                  torch.where(point_ids >= 0, False,
                              arena.point_valid[pid.long()]))
    ov = arena.obs_valid & pv[arena.obs_point.long()]
    return arena.replace(point_valid=pv, obs_valid=ov)


def erase_frame(arena: MapArena, frame_id) -> MapArena:
    fid = torch.as_tensor(frame_id, device=arena.device).long().reshape(1)
    fv = arena.frame_valid.index_fill(0, fid, False)
    ov = arena.obs_valid & (arena.obs_frame != fid)
    return arena.replace(frame_valid=fv, obs_valid=ov)


# ---------------------------------------------------------------------------
# covisibility


def _incidence(arena: MapArena) -> torch.Tensor:
    """(F, P) observation incidence, 0/1 in float32 (edges outside the
    capacities are dropped, as JAX's ``mode="drop"`` does)."""
    F, P = arena.cap_frames, arena.cap_points
    f, p = arena.obs_frame.long(), arena.obs_point.long()
    inside = (f >= 0) & (f < F) & (p >= 0) & (p < P)
    flat = torch.where(inside, f * P + p, 0)
    M = torch.zeros(F * P, dtype=torch.float32, device=arena.device)
    M = M.index_add(0, flat, (arena.obs_valid & inside).to(torch.float32))
    return M.clamp_(0, 1).reshape(F, P)


def covisibility_matrix(arena: MapArena) -> torch.Tensor:
    """(F, F) int32 shared-landmark counts between valid frames, the
    diagonal zeroed: one matrix product of the incidence matrix."""
    M = _incidence(arena)
    C = M @ M.T
    C = C * (1.0 - torch.eye(arena.cap_frames, dtype=C.dtype,
                             device=C.device))
    both = arena.frame_valid[:, None] & arena.frame_valid[None, :]
    return torch.where(both, C, torch.zeros_like(C)).to(torch.int32)


def _covis_row(arena: MapArena, frame_id) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(float32 shared-landmark counts of one frame against all valid
    others with its own entry zeroed, the frame id as a long tensor)."""
    M = _incidence(arena)
    fid = torch.as_tensor(frame_id, device=arena.device).long()
    row = (M @ M[fid]).index_fill(0, fid.reshape(1), 0.0)
    return torch.where(arena.frame_valid, row, torch.zeros_like(row)), fid


def covisibility_row(arena: MapArena, frame_id) -> torch.Tensor:
    """(cap_frames,) int32 shared-landmark counts of one frame against
    all others (its own entry zeroed)."""
    return _covis_row(arena, frame_id)[0].to(torch.int32)


def covisibility_topk(arena: MapArena, frame_id: torch.Tensor, k: int,
                      min_common: int = 15
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k covisible neighbours of one frame: (ids, counts), -1 pad;
    ties go to the lowest frame id, as ``lax.top_k`` breaks them."""
    row, _ = _covis_row(arena, frame_id)
    counts, ids = torch.sort(row, descending=True, stable=True)
    counts, ids = counts[:k], ids[:k]
    good = counts >= min_common
    return (torch.where(good, ids, -1).to(torch.int32),
            torch.where(good, counts, 0.0).to(torch.int32))


def frame_point_ids(arena: MapArena, frame_id: torch.Tensor,
                    max_points: int) -> torch.Tensor:
    """Point ids observed by a frame, in observation order, -1 padded."""
    hit = arena.obs_valid & (arena.obs_frame == frame_id)
    order = _stable_valid_first(hit)
    pts = torch.where(hit[order], arena.obs_point[order], -1)
    return pts[:max_points].to(torch.int32)


def covis_union_ids(arena: MapArena, frame_id: torch.Tensor,
                    slab_size: int, window: int,
                    min_common: int = 5) -> torch.Tensor:
    """Union of the point ids observed by ``frame_id`` and its top
    ``window`` covisible neighbours, deduplicated, largest id first, in
    a (slab_size,) slot array (-1 = empty)."""
    fid = torch.as_tensor(frame_id, device=arena.device)
    ids = [frame_point_ids(arena, fid, slab_size)]
    nbr, _ = covisibility_topk(arena, fid, k=window, min_common=min_common)
    for i in range(nbr.shape[0]):
        ids.append(torch.where(
            nbr[i] >= 0, frame_point_ids(arena, nbr[i].clamp_min(0),
                                         slab_size), -1))
    srt = torch.sort(torch.cat(ids)).values
    first = torch.arange(srt.shape[0], device=srt.device) == 0
    uniq = torch.where((srt != torch.roll(srt, 1)) | first, srt, -1)
    return torch.sort(uniq, descending=True).values[:slab_size].to(
        torch.int32)


# ---------------------------------------------------------------------------
# map hygiene


def cull_points(arena: MapArena, min_obs: int = 2,
                min_age_frames: int = 3) -> MapArena:
    """Erase landmarks older than ``min_age_frames`` keyframes that never
    gathered ``min_obs`` observations, and their observations."""
    age = arena.n_frames - arena.point_ref_frame
    bad = (arena.point_valid & (_obs_count(arena) < min_obs)
           & (age >= min_age_frames))
    pv = arena.point_valid & ~bad
    ov = arena.obs_valid & pv[arena.obs_point.long()]
    return arena.replace(point_valid=pv, obs_valid=ov)


def cull_by_found_ratio(arena: MapArena, min_visible: int = 10,
                        min_ratio: float = 0.1) -> MapArena:
    """Erase landmarks predicted visible in >= ``min_visible`` tracked
    frames but matched in fewer than ``min_ratio`` of them."""
    vis = arena.point_visible
    bad = (arena.point_valid & (vis >= min_visible)
           & (arena.point_found < min_ratio * vis))
    pv = arena.point_valid & ~bad
    ov = arena.obs_valid & pv[arena.obs_point.long()]
    return arena.replace(point_valid=pv, obs_valid=ov)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word (as a uint32 pattern)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def refresh_points(arena: MapArena, max_obs: int = 8) -> MapArena:
    """Refresh each landmark's viewing normal (mean unit camera->point
    direction over its observing keyframes) and representative
    descriptor (the observation with the least total Hamming distance to
    the point's other observations), from its first ``max_obs``
    observations in edge-list order."""
    dev = arena.device
    P = arena.cap_points
    O = max_obs
    order, ok_sorted, tgt_p, tgt_o = edge_slots(
        arena.obs_point, arena.obs_valid, P, O)

    f_sorted = arena.obs_frame[order].long()
    k_sorted = arena.obs_kp[order].long()
    desc_e = arena.frame_desc[f_sorted, k_sorted]               # (E, W)
    obs_desc = torch.zeros((P + 1, O, DESC_WORDS), dtype=torch.int32,
                           device=dev)
    obs_desc[tgt_p, tgt_o] = desc_e
    obs_desc = obs_desc[:P]
    obs_ok = torch.zeros((P + 1, O), dtype=torch.bool, device=dev)
    obs_ok[tgt_p, tgt_o] = ok_sorted
    obs_ok = obs_ok[:P]

    centers = se3_inverse(arena.frame_pose[:, :7])[:, :3]      # (F, 3)
    obs_ctr = torch.zeros((P + 1, O, 3), device=dev)
    obs_ctr[tgt_p, tgt_o] = centers[f_sorted]
    obs_ctr = obs_ctr[:P]
    d = arena.point_xyz[:, None, :] - obs_ctr
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-9)
    n_obs = obs_ok.sum(-1)
    normal = torch.where(obs_ok[..., None], d, 0.0).sum(1)
    normal = normal / torch.linalg.vector_norm(
        normal, dim=-1, keepdim=True).clamp_min(1e-9)
    has = (n_obs > 0) & arena.point_valid
    new_normal = torch.where(has[:, None], normal, arena.point_normal)

    x = obs_desc[:, :, None, :] ^ obs_desc[:, None, :, :]
    ham = _popcount32(x).sum(-1)                                # (P, O, O)
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    total = torch.where(pair_ok, ham, 0).sum(-1)
    total = torch.where(obs_ok, total, 1 << 30)
    best = torch.argmin(total, dim=-1)                          # first min
    best_desc = torch.take_along_dim(obs_desc, best[:, None, None],
                                     dim=1)[:, 0]
    new_desc = torch.where(has[:, None], best_desc, arena.point_desc)
    return arena.replace(point_normal=new_normal, point_desc=new_desc)


def _obs_count(arena: MapArena) -> torch.Tensor:
    return torch.zeros(arena.cap_points, dtype=torch.int32,
                       device=arena.device).index_add(
        0, arena.obs_point.long(), arena.obs_valid.to(torch.int32))


def redundant_frames(arena: MapArena, min_others: int = 3,
                     frac: float = 0.9) -> torch.Tensor:
    """(F,) mask of keyframes whose observed landmarks are, for at least
    ``frac`` of them, seen by ``min_others`` other keyframes."""
    well_seen = _obs_count(arena)[arena.obs_point.long()] >= (min_others + 1)
    per_f = torch.zeros(arena.cap_frames, dtype=torch.int32,
                        device=arena.device)
    f = arena.obs_frame.long()
    n_red = per_f.index_add(0, f, (arena.obs_valid & well_seen).to(
        torch.int32))
    n_tot = per_f.index_add(0, f, arena.obs_valid.to(torch.int32))
    return arena.frame_valid & (n_tot > 0) & (n_red >= frac * n_tot)


def compact_arena(arena: MapArena) -> Tuple[MapArena, torch.Tensor]:
    """Move valid points to the front (stable), remap and compact the
    observation list.  Returns (arena, old -> new point id map, -1 for
    erased points).  Frame slots never move."""
    dev = arena.device
    P = arena.cap_points
    order = _stable_valid_first(arena.point_valid)
    n_new = arena.point_valid.sum().to(torch.int32)
    old2new = torch.full((P,), -1, dtype=torch.int32, device=dev)
    old2new[order] = torch.arange(P, dtype=torch.int32, device=dev)
    old2new = torch.where(arena.point_valid, old2new, -1)
    new_pt = torch.where(arena.obs_valid, old2new[arena.obs_point.long()],
                         -1)
    ov = arena.obs_valid & (new_pt >= 0)
    oorder = _stable_valid_first(ov)
    arena = arena.replace(
        point_xyz=arena.point_xyz[order],
        point_normal=arena.point_normal[order],
        point_color=arena.point_color[order],
        point_desc=arena.point_desc[order],
        point_valid=arena.point_valid[order],
        point_ref_frame=arena.point_ref_frame[order],
        point_visible=arena.point_visible[order],
        point_found=arena.point_found[order],
        obs_frame=arena.obs_frame[oorder],
        obs_point=new_pt.clamp_min(0)[oorder],
        obs_kp=arena.obs_kp[oorder],
        obs_valid=ov[oorder],
        n_points=n_new,
        n_obs=ov.sum().to(torch.int32))
    return arena, old2new


# ---------------------------------------------------------------------------
# save / load / stats


def arena_to_numpy(arena: MapArena) -> dict:
    """Every field as numpy, in the JAX ``MapArena``'s dtypes:
    descriptors as uint32 words."""
    out = {}
    for name, t in arena.tensors():
        a = t.detach().cpu().numpy()
        if name in ("frame_desc", "point_desc"):
            a = a.astype(np.int32).view(np.uint32)
        out[name] = a
    return out


def arena_from_numpy(fields, device="cuda") -> MapArena:
    """A ``MapArena`` from numpy fields named as the JAX ``MapArena``'s
    (a dict, or an npz file's mapping); capacities come from the
    shapes."""
    dev = require_device(device)
    kw = {}
    for f in dataclasses.fields(MapArena):
        if f.name in _CAPS:
            continue
        a = np.asarray(fields[f.name])
        if f.name in ("frame_desc", "point_desc"):
            a = np.ascontiguousarray(a, np.uint32).view(np.int32)
        kw[f.name] = torch.from_numpy(np.array(a)).to(dev)
    return MapArena(cap_frames=kw["frame_pose"].shape[0],
                    cap_kps=kw["frame_kp_uv"].shape[1],
                    cap_points=kw["point_xyz"].shape[0],
                    cap_obs=kw["obs_frame"].shape[0], **kw)


def save_arena(arena: MapArena, path: str) -> None:
    """Snapshot to one .npz in the JAX package's layout, so a map file
    loads in both packages."""
    data = arena_to_numpy(arena)
    data["_caps"] = np.asarray([arena.cap_frames, arena.cap_kps,
                                arena.cap_points, arena.cap_obs])
    np.savez_compressed(path, **data)


def load_arena(path: str, device="cuda") -> MapArena:
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    P = int(fields["_caps"][2])
    for name in ("point_visible", "point_found"):
        fields.setdefault(name, np.zeros((P,), np.int32))
    return arena_from_numpy(fields, device=device)


def arena_stats(arena: MapArena) -> dict:
    """Host-side summary (counters and valid counts)."""
    return {
        "n_frames": int(arena.n_frames), "n_points": int(arena.n_points),
        "n_obs": int(arena.n_obs),
        "valid_frames": int(arena.frame_valid.sum()),
        "valid_points": int(arena.point_valid.sum()),
        "valid_obs": int(arena.obs_valid.sum()),
        "overflow": bool(arena.overflow),
    }


def merge_arenas(a: MapArena, b: MapArena,
                 transform_b: Optional[torch.Tensor] = None,
                 cap_frames: Optional[int] = None,
                 cap_points: Optional[int] = None,
                 cap_obs: Optional[int] = None) -> MapArena:
    """Merge two maps into one arena (multi-session / multi-sequence).

    ``b``'s live slots follow ``a``'s, its frame and point indices
    offset; ``transform_b`` (Sim3 (8,), e.g. from ``find_sim3``) maps b's
    world into a's.  Poses are world -> camera, so b's are rebased by
    RIGHT-composition with T^-1 (a-world -> b-world -> camera), which
    keeps each frame's camera-coordinate view of its own points; b's
    points move by T, their normals by T's rotation only.  Capacities
    default to the sums.  A host-side utility: it reads the six
    counters back once."""
    from gslam_tpu_torch.core.sim3 import sim3_apply, sim3_inverse, sim3_mul

    if a.cap_kps != b.cap_kps:
        raise ValueError(f"kp capacity mismatch {a.cap_kps} != {b.cap_kps}")
    na_f, nb_f, na_p, nb_p, na_o, nb_o = torch.stack(
        [a.n_frames, b.n_frames, a.n_points, b.n_points, a.n_obs,
         b.n_obs]).tolist()
    F = cap_frames or (a.cap_frames + b.cap_frames)
    P = cap_points or (a.cap_points + b.cap_points)
    E = cap_obs or (a.cap_obs + b.cap_obs)
    if F < na_f + nb_f or P < na_p + nb_p or E < na_o + nb_o:
        raise ValueError("merged capacities too small for live entries")

    moved = dict(point_ref_frame=b.point_ref_frame + na_f,
                 obs_frame=b.obs_frame + na_f,
                 obs_point=b.obs_point + na_p)
    if transform_b is not None:
        T = torch.as_tensor(transform_b, dtype=torch.float32,
                            device=b.device)
        R_only = torch.cat([torch.zeros_like(T[:3]), T[3:7],
                            torch.ones_like(T[7:])])
        moved.update(frame_pose=sim3_mul(b.frame_pose,
                                         sim3_inverse(T)[None]),
                     point_xyz=sim3_apply(T[None], b.point_xyz),
                     point_normal=sim3_apply(R_only[None], b.point_normal))

    out = make_arena(F, a.cap_kps, P, E, device=a.device)
    counts = {"frame": (na_f, nb_f), "point": (na_p, nb_p),
              "obs": (na_o, nb_o)}
    kw = {}
    for name, buf in out.tensors():
        axis = name.split("_")[0]
        if axis not in counts:
            continue
        n_a, n_b = counts[axis]
        buf = buf.clone()
        buf[:n_a] = getattr(a, name)[:n_a]
        buf[n_a:n_a + n_b] = moved.get(name, getattr(b, name))[:n_b]
        kw[name] = buf
    i32 = dict(dtype=torch.int32, device=a.device)
    return out.replace(n_frames=torch.tensor(na_f + nb_f, **i32),
                       n_points=torch.tensor(na_p + nb_p, **i32),
                       n_obs=torch.tensor(na_o + nb_o, **i32),
                       overflow=a.overflow | b.overflow, **kw)
