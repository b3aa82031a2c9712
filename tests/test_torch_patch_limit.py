"""The self k-NN's choice of kernel by patch size, on the CPU.

`ops.knn.knn_self` runs one of two kernels of csrc/knn.cu: the
shared-memory kernel where a block holds the patch (n <= `KNN_MAX_N`),
else `knn_self_stream`'s, which streams the candidates from device memory.
So the folded discrete path (`models.discrete.forward`) runs its kernels
on patches of any size, where the JAX package takes its XLA branch when a
fused kernel's size check fails (puflow_tpu/models/discrete.py). The
choice, `knn_self_in_smem`, needs no card; the card runs both kernels at
`KNN_MAX_N` and `KNN_MAX_N + 1` points in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from puflow_torch.ops import knn as knn_ops
from torch_threads import one_torch_thread  # noqa: F401

LIMIT = knn_ops.KNN_MAX_N


@pytest.mark.parametrize("n,smem", [(16, True), (256, True), (LIMIT, True),
                                    (LIMIT + 1, False), (4 * LIMIT, False)])
def test_knn_self_takes_the_shared_memory_kernel_within_its_limit(n, smem):
    assert knn_ops.knn_self_in_smem(n) is smem


def test_knn_limit_is_the_kernels_shared_memory():
    """`KNN_MAX_N` is the largest patch whose shared memory fits a block."""
    assert (knn_ops.knn_smem_bytes(LIMIT) <= knn_ops._SMEM_BYTES
            < knn_ops.knn_smem_bytes(LIMIT + 1))


def test_knn_self_stream_on_the_cpu_is_the_plain_version():
    """On a CPU tensor both wrappers give `knn_self_plain`'s indices."""
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 40, 3)
                         .astype(np.float32))
    ref = knn_ops.knn_self_plain(x, 16)
    assert torch.equal(knn_ops.knn_self_stream(x, 16), ref)
    assert torch.equal(knn_ops.knn_self(x, 16), ref)
