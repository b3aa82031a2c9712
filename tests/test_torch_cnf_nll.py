"""The port's CNF `forward` (the dense cloud and the NLL) against
puflow_tpu on the CPU, at the whole-model case of
tests/test_torch_cnf_model.py. Its own file: the NLL's exact-trace solves
and the differentiable masked solves of train=True take minutes on a CPU.

The parameters come from the JAX package as numpy trees and go through
`from_numpy_tree` or plain `torch.tensor`; inputs are numpy-seeded. The
shared cases are in tests/torch_cnf_cases.py; tests/test_torch_cnf*.py
split the CNF family's tests by what they hold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.models import continuous as t_cont
from puflow_tpu.models import continuous as j_cont

from torch_cnf_cases import B, N, R, case  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("folded", [False, True])
def test_forward_eval_matches_jax(case, folded):
    """`forward(train=False)`: the dense cloud and the NLL through the
    exact-trace field. atol 1e-4 on the cloud; the NLL is a mean of
    log-densities of size 1e2 summed over 64 points: rtol 1e-5 (measured
    equal to the six digits printed; the cloud 7.9e-6)."""
    jp = case["jf"] if folded else case["jp"]
    rx, rnll, _ = j_cont.forward(jp, case["js"], jnp.asarray(case["x"]), R,
                                 train=False)
    tp = case["tf"] if folded else case["tp"]
    with torch.no_grad():
        gx, gnll, new_state = t_cont.forward(tp, case["ts"], case["xt"], R)
    assert gx.shape == (B, N * R, 3)
    err = np.abs(gx.numpy() - np.asarray(rx)).max()
    print(f"continuous.forward folded={folded}: max_abs_err {err:.3e}, nll "
          f"{float(gnll):.6f} vs {float(rnll):.6f}")
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), atol=1e-4)
    np.testing.assert_allclose(float(gnll), float(rnll), rtol=1e-5)
    assert set(new_state) == {"interp", "feat_convs"}
    # train=True (BN on batch statistics, differentiable solves) runs on
    # the CPU; the unfolded trees, since training keeps BN
    with torch.no_grad():
        tx, tnll, t_state = t_cont.forward(case["tp"], case["ts"], case["xt"],
                                           R, train=True)
    assert tx.shape == (B, N * R, 3) and bool(torch.isfinite(tx).all())
    assert bool(torch.isfinite(tnll)) and set(t_state) == set(new_state)
