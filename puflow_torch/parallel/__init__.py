"""Data parallelism over the batch axis (`parallel.mesh`).

Counterpart of `puflow_tpu.parallel`: one rank a device, the parameters
replicated, the batch sharded. Where XLA inserts the collectives under a
sharded jit, the port calls them: global-batch BatchNorm statistics and
the NLL through a differentiable all-reduce (`all_reduce_sum`), one
all-reduce of the flat gradient a train step (`train.trainer`), the
sharded upsampler's outputs gathered by `gather_batch`, and each dopri5
attempt's error norm over the global batch summed by `rank_order_sum`,
the same bits on every rank.
"""

from puflow_torch.parallel.mesh import (Group, all_reduce_, all_reduce_sum,
                                        broadcast_, default_group,
                                        destroy_group, gather_batch,
                                        init_group, is_distributed,
                                        rank_order_sum, shard_batch)

__all__ = ["Group", "all_reduce_", "all_reduce_sum", "broadcast_",
           "default_group", "destroy_group", "gather_batch", "init_group",
           "is_distributed", "rank_order_sum", "shard_batch"]
