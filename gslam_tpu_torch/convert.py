"""State carried between the JAX package and the port, through numpy.

The tracking step has no weights; its state is the local-map slab and
the camera.  These functions turn the JAX package's arrays (as numpy)
into this package's tensors and back, so that both compute on the same
map.  Descriptors are uint32 words in numpy and int32 tensors with the
same bit pattern here (torch's uint32 supports few operations).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from gslam_tpu_torch.ops.frontend import DESC_WORDS, Features
from gslam_tpu_torch.ops.matching import Matches
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
