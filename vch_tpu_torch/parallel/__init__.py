"""Scenario batching and the multi-device paths of the port
(vch_tpu/parallel): the batched PGD problems, the scenario mesh on
torch.distributed (one process per device) and the grid-sharded solvers."""
from vch_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_batch
from vch_tpu_torch.parallel.batch import (BatchedProblem1D, BatchedProblem2D,
                                          LowMemBatchedProblem2D,
                                          make_batched_problem_2d)
from vch_tpu_torch.parallel.spatial import (GridShardedAdjoint2D,
                                            GridShardedBatchedProblem2D,
                                            GridShardedForward2D,
                                            GridShardedProblem2D)

__all__ = ["make_mesh", "shard_batch", "batch_sharding",
           "BatchedProblem1D", "BatchedProblem2D",
           "LowMemBatchedProblem2D", "make_batched_problem_2d",
           "GridShardedForward2D", "GridShardedAdjoint2D",
           "GridShardedProblem2D", "GridShardedBatchedProblem2D"]
