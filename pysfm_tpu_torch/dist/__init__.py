"""Distributed bundle adjustment over ``torch.distributed``: the mesh, the
point-sharded partition, the distributed Schur LM (dense and pcg) and the
multi-host glue.

Port of :mod:`pysfm_tpu.dist`, with the same public names.  One process per
rank holds one point shard; camera-sized partials are summed over the
process group (:mod:`pysfm_tpu_torch.utils.collectives`, which the solver
modules import as well).
"""

from pysfm_tpu_torch.dist import launch, multihost  # noqa: F401
from pysfm_tpu_torch.dist.mesh import AXIS, Mesh, make_mesh  # noqa: F401
from pysfm_tpu_torch.dist.shard import (  # noqa: F401
    ShardedProblem,
    device_put_sharded,
    shard_problem,
    unshard_points,
    unshard_problem,
)
from pysfm_tpu_torch.dist.sharded_cm import (  # noqa: F401
    ShardedCMProblem,
    device_put_sharded_cm,
    shard_cm_problem,
    solve_sharded_cm,
    unshard_cm,
)
from pysfm_tpu_torch.dist.sharded_lm import solve_sharded  # noqa: F401

__all__ = [
    "AXIS", "Mesh", "make_mesh",
    "ShardedProblem", "device_put_sharded", "shard_problem", "unshard_points",
    "unshard_problem", "solve_sharded",
    "ShardedCMProblem", "device_put_sharded_cm", "shard_cm_problem", "solve_sharded_cm",
    "unshard_cm",
]
