"""The parameter and timing helpers against puflow_tpu.

`count_parameters`, `parameter_breakdown`, `freeze_mask` and
`print_progress_log` give exactly what the JAX package's give on the same
tree; frozen leaves do not move under `torch.optim`; the timers log in
the JAX package's formats; `profile_trace` writes a trace on the CPU and,
unlike the JAX package's, lets an exception raised in its block out.
"""

import json
import re

import numpy as np
import pytest
import torch

from puflow_torch.checkpoint import _map_tree
from puflow_torch.utils import params as t_params
from puflow_torch.utils import timers as t_timers
from puflow_tpu.utils import params as j_params
from torch_threads import one_torch_thread  # noqa: F401


def _tree():
    return {"enc": {"w": np.zeros((2, 3), np.float32),
                    "layers": [{"w": np.zeros((4, 5)), "b": np.zeros(5)},
                               {"w": np.zeros((5, 1)), "b": np.zeros(1)}]},
            "interp": {"weight_unit": {"w": np.zeros(7)},
                       "knn": {"w": np.zeros((3, 3))}},
            "flow": [np.zeros(()), np.zeros((2, 2, 2))]}


def test_count_and_breakdown_match_jax():
    tree = _tree()
    torch_tree = _map_tree(torch.from_numpy, tree)
    for t in (tree, torch_tree):
        assert t_params.count_parameters(t) == j_params.count_parameters(tree)
        assert (t_params.parameter_breakdown(t)
                == j_params.parameter_breakdown(tree))
    assert t_params.count_parameters(tree) == 6 + 25 + 6 + 7 + 9 + 1 + 8


@pytest.mark.parametrize("prefixes", [[], ["enc"], ["interp/weight_unit"],
                                      ["enc/layers/1", "flow"], ["e"]])
def test_freeze_mask_matches_jax(prefixes):
    tree = _tree()
    got = t_params.freeze_mask(_map_tree(torch.from_numpy, tree), prefixes)
    want = j_params.freeze_mask(tree, prefixes)
    assert got == _map_tree(bool, want)


def test_freeze_mask_keeps_frozen_leaves_still_under_sgd():
    """Drop the frozen leaves' gradients before `step()`: with momentum
    and weight decay, SGD moves the trainable leaves and no frozen one."""
    gen = torch.Generator().manual_seed(0)
    params = {"enc": {"w": torch.randn(3, 4, generator=gen)},
              "flow": [{"w": torch.randn(4, generator=gen)},
                       {"w": torch.randn(2, generator=gen)}]}
    mask = t_params.freeze_mask(params, ["enc", "flow/1"])
    leaves = list(t_params.tree_leaves(params))
    before = [p.clone() for p in leaves]
    for p in leaves:
        p.requires_grad_()
    opt = torch.optim.SGD(leaves, lr=0.1, momentum=0.9, weight_decay=0.01)
    for _ in range(3):
        opt.zero_grad()
        sum((p * p).sum() for p in leaves).backward()
        for p, trainable in zip(leaves, t_params.tree_leaves(mask)):
            if not trainable:
                p.grad = None
        opt.step()
    moved = [not torch.equal(p.detach(), b) for p, b in zip(leaves, before)]
    assert moved == list(t_params.tree_leaves(mask)) == [False, True, False]


def test_progress_log_matches_jax():
    for args in [(3, {"CD": 0.5, "steps": 7}, ["lr 1e-3"]),
                 (12, {"NLL": -1.25, "EMD": 0.012345678}, ())]:
        got, want = [], []
        t_params.print_progress_log(*args, log_fn=got.append)
        j_params.print_progress_log(*args, log_fn=want.append)
        assert got == want
    assert "Epoch    3" in got[0] or "Epoch   12" in got[0]


def test_timers():
    lines = []
    timer = t_timers.ElapseTimer()
    assert timer.stop() == 0.0                     # stop before start
    timer.start()
    first = timer.stop()
    timer.start()
    assert timer.stop() >= first > 0.0
    timer.reset()
    assert timer.total == 0.0
    with t_timers.context_timer("block a", log_fn=lines.append):
        pass
    with t_timers.context_timer(log_fn=lines.append):
        pass

    @t_timers.func_timer(log_fn=lines.append)
    def add(a, b):
        return a + b

    assert add(2, 3) == 5
    assert add.__name__ == "add"
    assert [re.fullmatch(p, line) is not None for p, line in zip(
        [r"block a: \d+\.\d{4}s", r"block: \d+\.\d{4}s", r"add: \d+\.\d{4}s"],
        lines)] == [True, True, True]


def test_profile_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with t_timers.profile_trace(str(logdir)) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::matmul" in names
    trace = json.loads((logdir / "trace.json").read_text())
    assert any(e.get("name") == "aten::matmul"
               for e in trace["traceEvents"])


def test_profile_trace_reraises(tmp_path):
    """The JAX package's `profile_trace` swallows an exception raised in
    its block once the trace has started; the port's lets it out, and
    still writes the trace."""
    logdir = tmp_path / "trace"
    with pytest.raises(ValueError, match="inside the block"):
        with t_timers.profile_trace(str(logdir)):
            torch.ones(3).sum()
            raise ValueError("inside the block")
    assert (logdir / "trace.json").is_file()
