"""The port's CNF trainer against puflow_tpu's, on the CPU.

One train step of `Trainer(..., forward_fn=continuous.forward)` at a first
step's weights (seeded init; the CNF family has no ActNorm warm-up) and
the size of `tests/test_torch_adjoint_model.py` (B=2, N=64, r=4), against
JAX's jitted `make_train_step(optimizer, cfg, continuous.forward)` on the
same numpy inputs, with `eval_step(..., continuous.forward)` in the same
jitted program (one JAX compile for the file). Kept out of the
`test_torch_train*.py` files: those hold the discrete family. The CNF
train state's round trip is in tests/test_torch_cnf_resume.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from puflow_torch.models import continuous as t_cont
from puflow_torch.train import trainer as t_trainer
from puflow_tpu.data.synthetic import synthetic_pairs
from puflow_tpu.models import continuous as j_cont
from puflow_tpu.ops.emd import emd_auction as j_emd_auction
from puflow_tpu.train import trainer as j_trainer
from torch_threads import one_torch_thread  # noqa: F401

B, N, R, EMD_ITERS = 2, 64, 4, 5
ROUNDING_ZERO = 1e-4
STAGES = ["forward", "emd", "backward", "optimizer"]


def _leaf_items(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        path = f"{prefix}/{key}"
        if isinstance(val, (dict, list, tuple)):
            yield from _leaf_items(val, path)
        else:
            yield path, np.asarray(val)


def _maxrel(a, b) -> float:
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


def _rounding_zero(grads: dict) -> set:
    """The bias leaves whose largest gradient entry is below
    ``ROUNDING_ZERO`` times that of the same layer's weight (the biases
    before train-mode BN, whose true gradient is zero)."""
    peak = {n: float(np.abs(g).max()) for n, g in grads.items()}
    return {n for n in grads if n.endswith("/b") and n[:-1] + "w" in peak
            and peak[n] < ROUNDING_ZERO * peak[n[:-1] + "w"]}


def _record_grads():
    """An optax stage that passes the updates through and keeps them as
    its state: chained before the trainer's optimizer, the step's
    gradient comes out in the optimizer state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _with_pred(params, state, xyz, upratio, train=False):
    """`continuous.forward` that also hands out its dense cloud, in a
    state entry the train step carries through."""
    pred, logpx, new_state = j_cont.forward(
        params, {k: v for k, v in state.items() if k != "pred"}, xyz,
        upratio, train=train)
    return pred, logpx, {**new_state, "pred": pred}


def _cpu_trainer(params, state):
    cfg = t_trainer.TrainConfig(emd_iters=EMD_ITERS)
    return t_trainer.Trainer(cfg, params, state, forward_fn=t_cont.forward,
                             device="cpu")


@pytest.fixture(scope="module")
def case():
    """JAX's step and validation on one batch, then the port's step on it
    through a `Trainer`, recording its marks, gradient and assignment."""
    params, state = j_cont.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)
    sparse, dense = synthetic_pairs(np.random.RandomState(3), B, N, R)
    cfg = j_trainer.TrainConfig(emd_iters=EMD_ITERS)
    opt = optax.chain(_record_grads(), j_trainer.make_optimizer(cfg))
    step = j_trainer.make_train_step(opt, cfg, _with_pred)

    def program(p, s, sp, de):
        s_pred = {**s, "pred": jnp.zeros((B, N * R, 3), jnp.float32)}
        _, new_bn, opt_state, metrics = step(p, s_pred, opt.init(p), sp, de)
        _, assign = j_emd_auction(new_bn["pred"], de, cfg.emd_eps,
                                  cfg.emd_iters)
        ev = j_trainer.eval_step(p, s, sp, de, R, j_cont.forward)
        return new_bn, opt_state[0], metrics, assign, ev

    out = jax.jit(program)(params, state, jnp.asarray(sparse),
                           jnp.asarray(dense))
    new_bn, grads, metrics, assign, ev = jax.tree.map(np.asarray, out)
    jax_out = {"pred": new_bn.pop("pred"), "new_bn": new_bn,
               "grads": dict(_leaf_items(grads)), "metrics": metrics,
               "assign": assign, "eval": ev}

    tr = _cpu_trainer(params, state)
    rec = {"marks": []}
    update = tr.optimizer.update

    def recording_update(g, opt_state):
        rec["grads"] = g.clone()
        return update(g, opt_state)

    emd = t_trainer.emd_auction

    def recording_emd(pred, target, eps, iters):
        dist, rec["assign"] = emd(pred, target, eps, iters)
        rec["pred"] = pred.detach().clone()
        return dist, rec["assign"]

    tr.optimizer.update = recording_update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_trainer, "emd_auction", recording_emd)
        m = tr.step(sparse, dense, rec["marks"].append)
    tr.optimizer.update = update
    rec["metrics"] = {k: v.detach().clone() for k, v in m.items()}
    rec["bn_state"] = tr.bn_state.clone()
    return params, state, sparse, dense, jax_out, tr, rec


def test_cnf_tree_layout_holds_the_end_times(case):
    """The CNF trees as flat vectors: every block's `sqrt_end_time` scalar
    and its layer list, in the `.npz` key order, and back."""
    params, *_ = case
    layout = t_trainer.TreeLayout(params)
    ends = [p for p in layout.paths if p.endswith("sqrt_end_time")]
    assert ends == [f"flow_blocks/{i}/sqrt_end_time"
                    for i in range(t_cont.NUM_BLOCKS)]
    assert all(layout.shapes[layout.paths.index(p)] == () for p in ends)
    assert "flow_blocks/5/layers/2/hyper_gate/w" in layout.paths
    back = layout.numpy_tree(layout.flatten(params))
    assert isinstance(back["flow_blocks"][0]["layers"], list)
    for (pa, a), (pb, b) in zip(_leaf_items(back), _leaf_items(params),
                                strict=True):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_cnf_train_step_matches_jax(case):
    """The step's marks in order; the same EMD assignment; loss, NLL and
    EMD within 1e-4 relative; the new BN state within 1e-5; the step's
    gradient within 2e-2 max-relative in every leaf but the biases before
    train-mode BN, which are zero to rounding on both sides and none of
    them a CNF block's."""
    _, _, _, _, jax_out, tr, rec = case
    assert rec["marks"] == STAGES
    np.testing.assert_allclose(rec["pred"].numpy(), jax_out["pred"],
                               atol=1e-4)
    np.testing.assert_array_equal(rec["assign"].numpy(), jax_out["assign"])
    for k in ("loss", "logpx", "emd"):
        np.testing.assert_allclose(float(rec["metrics"][k]),
                                   float(jax_out["metrics"][k]), rtol=1e-4,
                                   err_msg=k)
    assert not bool(rec["metrics"]["nan_step"])
    assert not bool(jax_out["metrics"]["nan_step"])
    got_bn = dict(_leaf_items(tr.state_layout.numpy_tree(rec["bn_state"])))
    want_bn = dict(_leaf_items(jax_out["new_bn"]))
    assert got_bn.keys() == want_bn.keys()
    for path, w in want_bn.items():
        np.testing.assert_allclose(got_bn[path], w, atol=1e-5, err_msg=path)

    got = dict(_leaf_items(tr.param_layout.numpy_tree(rec["grads"])))
    want = jax_out["grads"]
    assert got.keys() == want.keys()
    assert all(np.isfinite(g).all() for g in got.values())
    zero = _rounding_zero(want)
    assert zero == _rounding_zero(got)
    assert not [n for n in zero if n.startswith("/flow_blocks/")]
    rels = {n: _maxrel(got[n], want[n]) for n in want if n not in zero}
    assert len(rels) > len(want) // 2
    worst = max(rels, key=rels.get)
    assert rels[worst] < 2e-2, (worst, rels[worst])


def test_cnf_eval_step_matches_jax(case):
    """Validation through `continuous.forward(train=False)`: ``vloss``
    within 1e-4 relative, the summed kaolin chamfer within 1e-4."""
    params, state, sparse, dense, jax_out, _, _ = case
    tp = t_trainer.TreeLayout(params)
    ts = t_trainer.TreeLayout(state)
    got = t_trainer.eval_step(tp.unflatten(tp.flatten(params)),
                              ts.unflatten(ts.flatten(state)),
                              torch.from_numpy(sparse),
                              torch.from_numpy(dense), R, t_cont.forward)
    np.testing.assert_allclose(float(got["vloss"]),
                               float(jax_out["eval"]["vloss"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["CD"]), float(jax_out["eval"]["CD"]),
                               atol=1e-4)
