"""Multi-device scale-out on torch.distributed: meshes of ranks, sharded
matching and landmark-sharded BA.

The port of monocularsfm_tpu/parallel: one rank per device, a one-axis
DeviceMesh over the default process group, collectives in place of the
JAX package's psum/ppermute inside shard_map.  Inside the pipeline rank 0
is the controller and the other ranks serve (parallel/serve.py).
"""

from monocularsfm_torch.parallel.mesh import init_multi_host, make_mesh
from monocularsfm_torch.parallel.distributed_ba import distributed_bundle_adjust
from monocularsfm_torch.parallel.sharded_matching import (
    ring_all_pairs_matching,
    sharded_match_pairs,
)

__all__ = [
    "make_mesh",
    "init_multi_host",
    "distributed_bundle_adjust",
    "sharded_match_pairs",
    "ring_all_pairs_matching",
]
