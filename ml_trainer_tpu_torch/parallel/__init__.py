"""Data parallelism for the port (the JAX package's ``parallel/``, the
part the data-parallel training path runs): the mesh, the collectives
over its replicas, the bucketed reduce-scatter / all-gather layout with
the ZeRO-1 rule, collective accounting and the (single-process)
rendezvous.  Replicas share one device; one process per card, tensor and
pipeline parallelism, ring and Ulysses attention are not ported yet
(ROADMAP.md Queue A).
"""

from ml_trainer_tpu_torch.parallel import collectives, comm_stats
from ml_trainer_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_primary,
    process_count,
    process_index,
)
from ml_trainer_tpu_torch.parallel.mesh import Mesh, create_mesh
from ml_trainer_tpu_torch.parallel.sharding import (
    GradBucketPlan,
    bucketed_all_gather,
    bucketed_reduce_scatter,
    join_replica_views,
    plan_grad_buckets,
    replica_view,
    zero1_opt_shardings,
    zero1_sharded,
)

__all__ = [
    "GradBucketPlan", "Mesh", "bucketed_all_gather", "bucketed_reduce_scatter",
    "collectives", "comm_stats", "create_mesh", "initialize_distributed",
    "is_primary", "join_replica_views", "plan_grad_buckets", "process_count",
    "process_index", "replica_view", "zero1_opt_shardings", "zero1_sharded",
]
