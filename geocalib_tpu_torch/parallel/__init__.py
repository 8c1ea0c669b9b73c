"""Data parallelism over torch.distributed (port of geocalib_tpu/parallel)."""

from geocalib_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, axis_index, axis_size, barrier,
                                              make_mesh, maybe_initialize_distributed,
                                              mean_over_ranks, min_over_ranks, process_count,
                                              process_index, replicated, shard_batch,
                                              sum_over_ranks)

__all__ = ["DATA_AXIS", "Mesh", "axis_index", "axis_size", "barrier", "make_mesh",
           "maybe_initialize_distributed", "mean_over_ranks", "min_over_ranks", "process_count",
           "process_index", "replicated", "shard_batch", "sum_over_ranks"]
