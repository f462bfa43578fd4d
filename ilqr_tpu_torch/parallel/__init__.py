from ilqr_tpu_torch.parallel.mesh import make_mesh
from ilqr_tpu_torch.parallel.sharding import (
    shard_batch,
    sharded_solve_fn,
    sharded_kernel_solve_fn,
    run_mpc_chunked_sharded,
    aggregate_stats,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "sharded_solve_fn",
    "sharded_kernel_solve_fn",
    "run_mpc_chunked_sharded",
    "aggregate_stats",
]
