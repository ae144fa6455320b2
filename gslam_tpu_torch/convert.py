"""State carried between the JAX package and the port, through numpy.

The system has no weights; its state is the map (the local-map slab of
the tracking step, the whole ``MapArena`` of the SLAM loop, a BA
problem, a pose graph), the vocabulary and the camera.  These functions
turn the JAX package's arrays (as numpy) into this package's tensors and
back, so that both compute on the same map; ``arena_from_numpy`` /
``arena_to_numpy`` are those of :mod:`gslam_tpu_torch.map.arena`,
``vocabulary_from_numpy`` / ``vocabulary_to_numpy`` those of
:mod:`gslam_tpu_torch.ops.vocab`.  Descriptors are uint32 words in
numpy and int32 tensors with the same bit pattern here (torch's uint32
supports few operations).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from gslam_tpu_torch.map.arena import (  # noqa: F401  (the map's carriers)
    arena_from_numpy, arena_to_numpy,
)
from gslam_tpu_torch.ops.frontend import DESC_WORDS, Features
from gslam_tpu_torch.ops.matching import Matches
from gslam_tpu_torch.ops.vocab import (  # noqa: F401  (the tree's carriers)
    vocabulary_from_numpy, vocabulary_to_numpy,
)
from gslam_tpu_torch.opt.ba import BundleProblem
from gslam_tpu_torch.opt.pose_graph import PoseGraph
from gslam_tpu_torch.utils.platform import require_device


def desc_from_numpy(desc_u32: np.ndarray, device="cuda") -> torch.Tensor:
    """(N, 8) uint32 words -> (N, 8) int32 tensor, same bits."""
    d = np.ascontiguousarray(desc_u32, dtype=np.uint32)
    if d.ndim != 2 or d.shape[1] != DESC_WORDS:
        raise ValueError(f"descriptors must be (N, {DESC_WORDS}), got "
                         f"{d.shape}")
    return torch.from_numpy(d.view(np.int32).copy()).to(
        require_device(device))


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """(N, 8) int32 tensor -> (N, 8) uint32 words, same bits."""
    return desc.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def map_slab_from_numpy(xyz: np.ndarray, desc_u32: np.ndarray,
                        valid: np.ndarray, device="cuda"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local-map slab -> (xyz (M, 3) float32, desc (M, 8) int32,
    valid (M,) bool) on ``device``."""
    dev = require_device(device)
    xyz_t = torch.tensor(np.asarray(xyz, np.float32), device=dev)
    valid_t = torch.tensor(np.asarray(valid, bool), device=dev)
    desc_t = desc_from_numpy(desc_u32, dev)
    M = xyz_t.shape[0]
    if xyz_t.shape != (M, 3) or desc_t.shape[0] != M or \
            valid_t.shape != (M,):
        raise ValueError("map slab shapes disagree: xyz "
                         f"{tuple(xyz_t.shape)}, desc {tuple(desc_t.shape)},"
                         f" valid {tuple(valid_t.shape)}")
    return xyz_t, desc_t, valid_t


def camera_from_numpy(params: np.ndarray, device="cuda") -> torch.Tensor:
    """Pinhole [fx, fy, cx, cy] -> (4,) float32 tensor on ``device``."""
    p = np.asarray(params, np.float32)
    if p.shape != (4,):
        raise ValueError(f"pinhole params must be (4,), got {p.shape}")
    return torch.tensor(p, device=require_device(device))


def features_to_numpy(f: Features) -> Dict[str, np.ndarray]:
    """Features -> dict of numpy arrays, descriptors as uint32 words (the
    JAX package's layout)."""
    out = {k: v.detach().cpu().numpy() for k, v in f._asdict().items()}
    out["desc"] = desc_to_numpy(f.desc)
    return out


def matches_to_numpy(m: Matches) -> Dict[str, np.ndarray]:
    """Matches -> dict of numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in m._asdict().items()}


def bundle_problem_from_numpy(fields, device="cuda"):
    """A BA problem as numpy (a ``BundleProblem``-shaped tuple or a dict
    of its field names) -> :class:`~gslam_tpu_torch.opt.ba.BundleProblem`
    on ``device``."""
    dev = require_device(device)
    if not isinstance(fields, dict):
        fields = dict(zip(BundleProblem._fields, fields))
    dtypes = dict(cam_pose=np.float32, cam_fixed=bool, point_xyz=np.float32,
                  point_fixed=bool, obs_cam=np.int32, obs_uv=np.float32,
                  obs_valid=bool, obs_weight=np.float32)
    return BundleProblem(**{
        k: torch.from_numpy(np.array(fields[k], dtype=dtypes[k])).to(dev)
        for k in BundleProblem._fields})


def pose_graph_from_numpy(fields, device="cuda") -> PoseGraph:
    """A pose graph as numpy (a ``PoseGraph``-shaped tuple or a dict of
    its field names; the position prior may be absent or None) ->
    :class:`~gslam_tpu_torch.opt.pose_graph.PoseGraph` on ``device``."""
    dev = require_device(device)
    if not isinstance(fields, dict):
        fields = dict(zip(PoseGraph._fields, fields))
    dtypes = dict(poses=np.float32, fixed=bool, edge_i=np.int32,
                  edge_j=np.int32, edge_rel=np.float32, edge_valid=bool,
                  edge_weight=np.float32, prior_pos=np.float32,
                  prior_weight=np.float32)
    return PoseGraph(**{
        k: None if fields.get(k) is None else torch.from_numpy(
            np.array(fields[k], dtype=dtypes[k])).to(dev)
        for k in PoseGraph._fields})
