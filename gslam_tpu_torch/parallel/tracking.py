"""Frame-parallel tracking over a 'dp' mesh (the data-parallel analog).

Counterpart of ``gslam_tpu/parallel/tracking.py``: B frames (different
sequences, or a window of one re-localized against a fixed map) are
split over the ranks of a 1-D mesh in contiguous blocks; each rank runs
the fused tracking step (:func:`gslam_tpu_torch.models.graft.track_forward`:
B1, B2, B3) on its frames, one after another (a kernel launch takes one
frame, so there is no ``vmap``), against the same replicated map slab,
and the outputs are all-gathered.  The step itself needs no
communication.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from gslam_tpu_torch.parallel.dist_ba import all_gather_cat
from gslam_tpu_torch.parallel.mesh import shard_points


def sharded_track_batch(mesh: DeviceMesh, images: torch.Tensor,
                        cam_params: torch.Tensor, map_xyz: torch.Tensor,
                        map_desc: torch.Tensor, map_valid: torch.Tensor,
                        uniforms: torch.Tensor, max_kps: int = 512,
                        ransac_b: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track B frames against one map slab, B split over the mesh's 'dp'
    axis; every rank of the mesh calls it with the same inputs.

    images (B, H, W) float32; cam_params (4,); map_* the slab;
    uniforms (B, ransac_b, 4), each frame's RANSAC draws (the reference
    takes a PRNG key per frame).  Runs on the images' device, through
    the kernels on the card (their plain versions on the CPU).  Returns
    (poses (B, 7), n_inliers (B,), n_features (B,)) on every rank.  B
    must be a multiple of the 'dp' size (pad upstream)."""
    from gslam_tpu_torch.models.graft import track_forward

    group = mesh.get_group("dp")
    outs = [track_forward(img, cam_params, map_xyz, map_desc, map_valid,
                          uniforms=u, max_kps=max_kps, ransac_b=ransac_b,
                          device=images.device)
            for img, u in zip(shard_points(images, mesh, "dp"),
                              shard_points(uniforms, mesh, "dp"))]
    poses, n_inl, n_feat = (torch.stack(x) for x in zip(*outs))
    return (all_gather_cat(poses, group), all_gather_cat(n_inl, group),
            all_gather_cat(n_feat, group))
