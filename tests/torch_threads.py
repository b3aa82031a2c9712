"""One torch intra-op thread while a port test module runs.

The suite runs under xdist, several workers on a host of few cores. A
torch CPU op that runs in parallel waits at a barrier for every thread of
its worker's OpenMP pool, which is as wide as the host; with several such
pools on one host the barriers wait on the scheduler, and a test of many
small ops slows by orders of magnitude (on an 8-core host, six copies of
`test_torch_guards.py::test_cnf_training_is_not_ported`, 6 s alone, ran
for over 40 minutes side by side at the default width and for 9 s with
one thread each). The port's tests run small shapes, for which one thread
is as fast alone. Each `tests/test_torch_*.py` that runs torch on the CPU
imports `one_torch_thread`.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
