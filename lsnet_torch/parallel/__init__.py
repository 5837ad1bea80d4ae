"""Data parallelism over ``torch.distributed`` (counterpart of
``lsnet_tpu/parallel``): see :mod:`lsnet_torch.parallel.mesh`."""

from .mesh import (all_reduce_sum, barrier, batch_mean,  # noqa: F401
                   collect_results, gather_outputs, gather_rows,
                   global_count, init_launcher, initialize_distributed,
                   is_main_process, rank, rank_device, reduce_gradients,
                   shard_batch_pytree, shard_rows, world_size)
