"""Device meshes over ``torch.distributed``.

Counterpart of ``gslam_tpu/parallel/mesh.py``.  A JAX process drives
every device of its mesh; here each rank is one process, so a mesh is a
``DeviceMesh`` over the ranks of the initialized process group
(:mod:`gslam_tpu_torch.parallel.launch`).  Rank r sits at
(r // n_obs, r % n_obs), row-major, as JAX's ``np.asarray(devs)
.reshape(shape)`` places devices.  The device type is the tensors' device:
``"cuda"`` on the card, ``"cpu"`` for a gloo world on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device) -> str:
    return torch.device(device).type


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("pt", "obs"),
              device="cuda") -> DeviceMesh:
    """2-D mesh over every rank: (n, 1) by default, all ranks sharding
    landmarks ('pt'); (n // 2, 2) etc. also shards observation slots
    ('obs').  Every rank of the world calls it."""
    n = dist.get_world_size()
    shape = (n, 1) if shape is None else tuple(shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=tuple(axis_names))


def make_dp_mesh(n: Optional[int] = None, device="cuda") -> DeviceMesh:
    """1-D frame-parallel mesh (axis 'dp') over the n ranks of the world
    (all of them by default), for :mod:`.tracking`."""
    world = dist.get_world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a 'dp' mesh spans the world: {n} != {world}")
    return init_device_mesh(_device_type(device), (n,),
                            mesh_dim_names=("dp",))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def shard_points(x: torch.Tensor, mesh: DeviceMesh,
                 axis: str = "pt") -> torch.Tensor:
    """This rank's contiguous block of the P-major ``x`` (P over
    ``axis``): the counterpart of the reference's ``shard_points_spec``,
    the ``P("pt")`` layout.  P must be a multiple of the axis size."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
    blk = x.shape[0] // n
    i = mesh.get_local_rank(axis)
    return x[i * blk:(i + 1) * blk]
