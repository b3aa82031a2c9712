"""Data parallelism over the batch axis (`parallel.mesh`).

Counterpart of `puflow_tpu.parallel`: one rank a device, the parameters
replicated, the batch sharded. Where XLA inserts the collectives under a
sharded jit, the port calls them: global-batch BatchNorm statistics and
the NLL through a differentiable all-reduce (`all_reduce_sum`), one
all-reduce of the flat gradient a train step (`train.trainer`), and the
sharded upsampler's outputs gathered by `gather_batch`.
"""

from puflow_torch.parallel.mesh import (Group, all_reduce_, all_reduce_sum,
                                        broadcast_, default_group,
                                        destroy_group, gather_batch,
                                        init_group, is_distributed,
                                        shard_batch)

__all__ = ["Group", "all_reduce_", "all_reduce_sum", "broadcast_",
           "default_group", "destroy_group", "gather_batch", "init_group",
           "is_distributed", "shard_batch"]
