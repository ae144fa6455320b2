"""Distribution: meshes of ranks, the distributed Schur BA, frame-parallel
tracking (counterpart of ``gslam_tpu/parallel``).

Each rank is one process in a ``torch.distributed`` group
(:mod:`.launch`): on the card NCCL, one rank a card; on the CPU gloo.
Global BA runs as a distributed Schur complement: each landmark block
is inverted where it lives, partial reduced camera systems are summed
across ranks, every rank solves the small replicated system, and
landmark updates back-substitute locally.
"""

from gslam_tpu_torch.parallel.mesh import (  # noqa: F401
    make_dp_mesh, make_mesh, shard_points,
)
from gslam_tpu_torch.parallel.dist_ba import (  # noqa: F401
    distributed_bundle_adjust, distributed_bundle_adjust_ring,
)
from gslam_tpu_torch.parallel.tracking import sharded_track_batch  # noqa: F401
