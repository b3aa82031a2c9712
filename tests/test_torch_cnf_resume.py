"""The port's CNF trainer on the CPU without JAX: the train state's
`save_train_state` / `restore_train_state` round trip on the CNF trees
(their `sqrt_end_time` scalars and layer lists), at the size of
tests/test_torch_cnf_train.py."""

import numpy as np
import torch

from puflow_torch.data.synthetic import synthetic_pairs
from puflow_torch.models import continuous as t_cont
from puflow_torch.train import trainer as t_trainer
from torch_threads import one_torch_thread  # noqa: F401

B, N, R, EMD_ITERS = 2, 64, 4, 5


def _cpu_trainer(params, state):
    cfg = t_trainer.TrainConfig(emd_iters=EMD_ITERS)
    return t_trainer.Trainer(cfg, params, state, forward_fn=t_cont.forward,
                             device="cpu")


def test_cnf_train_state_round_trip_reproduces_the_next_step(tmp_path):
    """`save_train_state` after a first step, `restore_train_state` into a
    new CNF trainer: the next step's loss, parameters and BN state equal
    the first trainer's, and the checkpoint reads back as a CNF model."""
    from puflow_torch import checkpoint

    params, state = t_cont.init(torch.Generator().manual_seed(0),
                                device="cpu")
    rng = np.random.RandomState(3)
    first, second = (synthetic_pairs(rng, B, N, R) for _ in range(2))
    tr = _cpu_trainer(params, state)
    tr.train_epoch([first])
    tr._plateau_update(1.0)
    path = str(tmp_path / "cnf.npz")
    tr.save_train_state(path)

    again = _cpu_trainer(params, state)
    assert again.restore_train_state(path) == 0
    assert again.opt_state.count == 1 and again._best == 1.0
    torch.testing.assert_close(again.params, tr.params, atol=0, rtol=0)
    want = tr.step(*second)
    got = again.step(*second)
    assert float(got["loss"]) == float(want["loss"])
    assert not bool(got["nan_step"])
    assert torch.equal(again.params, tr.params)
    assert torch.equal(again.bn_state, tr.bn_state)
    assert torch.equal(again.opt_state.nu, tr.opt_state.nu)

    model = checkpoint.load_checkpoint(path, "cpu", model="cnf")
    ends = [float(b["sqrt_end_time"])
            for b in model.trees()[0]["flow_blocks"]]
    # the first step moved every end time off its initial value
    assert len(ends) == t_cont.NUM_BLOCKS
    assert all(e != np.float32(np.sqrt(t_cont.T_INIT)) for e in ends)
