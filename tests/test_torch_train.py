"""puflow_torch's discrete training path against puflow_tpu's, on the CPU:
the tests at a first training step's weights (`case`: one JAX train-graph
compile for the file).

The same numpy parameters and the same numpy batch go through both
packages: ActNorm warm-up, the NLL, train-mode BatchNorm's statistics, the
whole loss's gradients, the NaN guard, the plateau controller, resume and
checkpoints. Tolerances are the JAX package's own (`tests/test_train.py`,
`tests/test_resume.py`). The perturbed weights' gradients are in
tests/test_torch_train_grads.py, the tests that need no model in
tests/test_torch_train_units.py, the shared cases in
tests/torch_train_cases.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.data.synthetic import synthetic_pairs as t_synthetic_pairs
from puflow_torch.models import discrete as t_discrete
from puflow_torch.ops.emd import emd_auction as t_emd_auction
from puflow_torch.train import trainer as t_trainer
from puflow_tpu.checkpoint import load_npz_checkpoint as j_load_npz
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.train import trainer as j_trainer
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import (B, EMD_ITERS, N, R,  # noqa: F401
                               _assert_grads_close, _assert_trees_close,
                               _trainer, case, perturbed)


def test_actnorm_warmup_and_log_prob_match_jax(case, perturbed):
    _, _, sparse, _, _ = case
    params, state = perturbed
    jp = j_discrete.actnorm_warmup(params, state, jnp.asarray(sparse))
    model = t_checkpoint.from_numpy_tree(params, state, "cpu")
    tp, ts = model.trees()
    xt = torch.from_numpy(sparse)
    wp = t_discrete.actnorm_warmup(tp, ts, xt)
    for tb, jb in zip(wp["flow_blocks"], jp["flow_blocks"]):
        for k in ("logs", "bias"):
            np.testing.assert_allclose(tb["actnorm"][k].numpy(),
                                       np.asarray(jb["actnorm"][k]),
                                       atol=1e-5)
    # log_prob with the warmed params on the same conditions
    idx = t_discrete.knn_indices(xt, xt, t_discrete.NUM_NEIGHBORS)
    cs, _ = t_discrete.feat_extract(wp, ts, xt, idx)
    _, nll = t_discrete.log_prob(wp, xt, cs)
    j_cs, _ = j_discrete.feat_extract(
        jp, jax.tree.map(jnp.asarray, state), jnp.asarray(sparse),
        jnp.asarray(idx.numpy()), train=False)
    _, j_nll = j_discrete.log_prob(jp, jnp.asarray(sparse), j_cs)
    # a mean of sums over N * 3 log-densities: relative 1e-6
    np.testing.assert_allclose(float(nll), float(j_nll),
                               atol=1e-5 * max(1.0, abs(float(j_nll))))


def test_train_forward_bn_state_and_nll_match_jax(case):
    """The step's forward at its weights: prediction, NLL and the moved
    BN running statistics."""
    params, state, sparse, _, jax_out = case
    model = t_checkpoint.from_numpy_tree(params, state, "cpu")
    tp, ts = model.trees()
    with torch.no_grad():
        pred, nll, new_bn = t_discrete.forward(
            tp, ts, torch.from_numpy(sparse), R, train=True)
    assert pred.shape == (B, N * R, 3)
    np.testing.assert_allclose(pred.numpy(), jax_out["pred"], atol=1e-4)
    np.testing.assert_allclose(float(nll), float(jax_out["logpx"]),
                               atol=1e-5 * max(1.0, abs(float(nll))))
    _assert_trees_close(jax.tree.map(lambda t: t.numpy(), new_bn),
                        jax_out["new_bn"], atol=1e-5)


def test_train_step_gradients_match_jax(case):
    """The whole loss's gradients per leaf within ``5e-4 * scale + 1e-6``,
    after checking that both EMDs took the same assignment."""
    params, state, sparse, dense, jax_out = case
    layout = t_trainer.TreeLayout(params)
    leaf = layout.flatten(params).requires_grad_()
    s_layout = t_trainer.TreeLayout(state)
    pred, logpx, _ = t_discrete.forward(
        layout.unflatten(leaf), s_layout.unflatten(s_layout.flatten(state)),
        torch.from_numpy(sparse), R, train=True)
    dist, assign = t_emd_auction(pred, torch.from_numpy(dense), 0.005,
                                 EMD_ITERS)
    np.testing.assert_array_equal(assign.numpy(), jax_out["assign"])
    loss = logpx * 1e-4 + torch.sum(dist) * 5e-2
    np.testing.assert_allclose(float(loss.detach()), float(jax_out["loss"]),
                               rtol=1e-5)
    (grad,) = torch.autograd.grad(loss, leaf)
    _assert_grads_close(layout.numpy_tree(grad), jax_out["grads"])


def test_nan_guard_keeps_params_and_bn_state(case):
    params, state, sparse, dense, _ = case
    tr = _trainer(params, state)
    p0, s0 = tr.params.clone(), tr.bn_state.clone()
    bad = sparse.copy()
    bad[0, 0, 0] = np.nan
    m = tr.train_epoch([(bad, dense)])
    assert m["nan_step"] == 1.0
    assert tr.opt_state.count == 1
    assert torch.equal(tr.params, p0)
    assert torch.equal(tr.bn_state, s0)


def test_plateau_matches_jax_trainer(case):
    params, state, _, _, _ = case
    jt = j_trainer.Trainer(j_trainer.TrainConfig(emd_iters=EMD_ITERS),
                           params, state)
    tt = _trainer(params, state)
    seq = [1.0] + [2.0] * 11 + [0.5] + [0.6] * 40 + [0.1] + [0.2] * 100
    for v in seq:
        jt._plateau_update(v)
        tt._plateau_update(v)
        assert tt._lr == jt._lr
        assert tt._bad_epochs == jt._bad_epochs
    assert tt._lr == tt.cfg.min_lr


def test_loss_decreases_and_set_lr_takes_effect(case):
    params, state, _, _, _ = case
    tr = _trainer(params, state, learning_rate=5e-4)
    batch = t_synthetic_pairs(np.random.RandomState(0), B, N, R)
    tr._lr = 0.0
    p0 = tr.params.clone()
    tr.train_epoch([batch])
    assert torch.equal(tr.params, p0)
    tr._lr = 5e-4
    m0 = tr.train_epoch([batch] * 2)
    m1 = tr.train_epoch([batch] * 4)
    assert m1["loss"] < m0["loss"]
    assert m1["nan_step"] == 0.0


def test_cd_weight_adds_chamfer_to_the_loss(case):
    """The pugan recipe adds CD * cd_weight to the objective."""
    params, state, sparse, dense, _ = case
    losses = [float(_trainer(params, state, cd_weight=w).step(
        sparse, dense)["loss"]) for w in (0.0, 1e-1)]
    assert losses[1] > losses[0]


def test_resume_reproduces_training(case, tmp_path):
    params, state, _, _, _ = case
    rng = np.random.RandomState(0)
    b1 = t_synthetic_pairs(rng, B, N, R)
    b2 = t_synthetic_pairs(rng, B, N, R)
    ta = _trainer(params, state, learning_rate=5e-4)
    ta.train_epoch([b1])
    ma = ta.train_epoch([b2])

    tb = _trainer(params, state, learning_rate=5e-4)
    tb.train_epoch([b1])
    tb._plateau_update(1.0)
    ckpt = str(tmp_path / "state.npz")
    tb.save_train_state(ckpt)

    tc = _trainer(params, state, learning_rate=5e-4)
    assert tc.restore_train_state(ckpt) == 0
    assert tc.opt_state.count == 1 and tc._best == 1.0
    mc = tc.train_epoch([b2])
    assert abs(ma["loss"] - mc["loss"]) < 1e-4 * max(abs(ma["loss"]), 1.0)
    torch.testing.assert_close(tc.params, ta.params, atol=1e-6, rtol=0)


def test_checkpoint_loads_in_jax(case, tmp_path):
    """A port-saved checkpoint reads back through the JAX package with
    equal arrays, and the port reads it as a model."""
    params, state, sparse, dense, _ = case
    tr = _trainer(params, state)
    tr.train_epoch([(sparse, dense)])
    path = str(tmp_path / "m.npz")
    tr.save_train_state(path)
    jp, js = j_load_npz(path)
    tp, ts = tr.numpy_params()
    _assert_trees_close(jp, tp, atol=0)
    _assert_trees_close(js, ts, atol=0)
    model = t_checkpoint.load_checkpoint(path, device="cpu")
    _assert_trees_close(jax.tree.map(lambda t: t.numpy(), model.trees()[0]),
                        tp, atol=0)
