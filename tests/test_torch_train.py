"""puflow_torch's discrete training path against puflow_tpu's, on the CPU.

The same numpy parameters and the same numpy batch go through both
packages: train-mode BatchNorm, ActNorm warm-up, the NLL, the whole
loss's gradients at a first training step (one JAX train-graph compile
for the file) and the encoder and flow gradients at perturbed weights,
the clip + Adam arithmetic against optax's chain, the plateau controller,
resume and checkpoints. Tolerances are the JAX
package's own (`tests/test_train.py`, `tests/test_resume.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.data.synthetic import synthetic_pairs as t_synthetic_pairs
from puflow_torch.models import discrete as t_discrete
from puflow_torch.models import encoder as t_encoder
from puflow_torch.models import nn as t_nn
from puflow_torch.ops.emd import emd_auction as t_emd_auction
from puflow_torch.train import trainer as t_trainer
from puflow_tpu.checkpoint import load_npz_checkpoint as j_load_npz
from puflow_tpu.data.synthetic import synthetic_pairs
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.models import encoder as j_encoder
from puflow_tpu.models import nn as j_nn
from puflow_tpu.ops.emd import emd_auction as j_emd_auction
from puflow_tpu.train import trainer as j_trainer

B, N, R, EMD_ITERS = 4, 40, 4, 5


def _leaf_items(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        path = f"{prefix}/{key}"
        if isinstance(val, (dict, list, tuple)):
            yield from _leaf_items(val, path)
        else:
            yield path, np.asarray(val)


def _assert_trees_close(got, want, atol):
    got, want = dict(_leaf_items(got)), dict(_leaf_items(want))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol,
                                   err_msg=path)


@pytest.fixture(scope="module")
def case():
    """Numpy weights, one batch, and the JAX train step's loss, gradients,
    new BN state, prediction and assignment.

    The weights are those of a first training step: seeded init, then the
    ActNorm warm-up, the state the JAX package's own gradient test runs
    in (`tests/test_train.py`). Heavier perturbed weights make the f32
    gradient of the whole graph ill-conditioned in both frameworks: a
    rounding-level difference that moves a LeakyReLU input across 0, or
    flips the maximum of the K-slot pool, reroutes a gradient term, and
    the two packages then differ by far more than rounding although each
    computes the same function. The module tests below hold the encoder
    and flow gradients at perturbed weights, where such flips stay out.
    """
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    sparse, dense = synthetic_pairs(np.random.RandomState(3), B, N, R)
    params = j_discrete.actnorm_warmup(params, state, jnp.asarray(sparse))
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)

    def loss_fn(p, s, sp, de):
        pred, logpx, new_bn = j_discrete.forward(p, s, sp, R, train=True)
        dist, assign = j_emd_auction(pred, de, 0.005, EMD_ITERS)
        loss = logpx * 1e-4 + jnp.sum(dist) * 5e-2
        return loss, (new_bn, logpx, pred, assign)

    (loss, (new_bn, logpx, pred, assign)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        params, state, jnp.asarray(sparse), jnp.asarray(dense))
    jax_out = jax.tree.map(np.asarray, {
        "loss": loss, "grads": grads, "new_bn": new_bn, "logpx": logpx,
        "pred": pred, "assign": assign})
    return params, state, sparse, dense, jax_out


@pytest.fixture(scope="module")
def perturbed():
    """Seeded init moved far from the identity (`perturb_init`)."""
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    return t_discrete.perturb_init(jax.tree.map(np.array, params),
                                   jax.tree.map(np.array, state), 7)


def _assert_grads_close(got, want):
    """Per leaf within ``5e-4 * scale + 1e-6`` (`tests/test_train.py`)."""
    got, want = dict(_leaf_items(got)), dict(_leaf_items(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(got[path], w, atol=5e-4 * scale + 1e-6,
                                   err_msg=path)


def test_bn_train_mode_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 10, 6, 5) * 2 + 1).astype(np.float32)
    p = {"scale": rng.rand(5).astype(np.float32),
         "bias": rng.randn(5).astype(np.float32)}
    s = {"mean": rng.randn(5).astype(np.float32),
         "var": rng.rand(5).astype(np.float32) + 0.5}
    for train in (True, False):
        y_j, s_j = j_nn.bn_apply(p, s, jnp.asarray(x), train)
        y_t, s_t = t_nn.bn_apply(
            {k: torch.from_numpy(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in s.items()},
            torch.from_numpy(x), train)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(s_t[k].numpy(), np.asarray(s_j[k]),
                                       atol=1e-5)


def test_prior_matches_jax():
    from puflow_torch.flows import prior as t_prior
    from puflow_tpu.flows import prior as j_prior

    z = np.random.RandomState(2).randn(3, 10, 3).astype(np.float32)
    np.testing.assert_allclose(
        t_prior.standard_gaussian_logp(torch.from_numpy(z)).numpy(),
        np.asarray(j_prior.standard_gaussian_logp(jnp.asarray(z))),
        rtol=1e-6)
    # the temperature is squared, as in the reference
    s = t_prior.standard_gaussian_sample(torch.Generator().manual_seed(0),
                                         (40000,), temperature=0.5)
    assert abs(float(s.std()) - 0.25) < 0.005


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


def _torch_tree(tree, grad=False):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=grad), tree)


def test_encoder_block_gradients_match_jax(perturbed):
    """One train-mode EdgeConv block and its merge MLP at perturbed
    weights: gradients of a fixed projection of the condition (a mean, so
    the analytically zero gradients of the biases before train-mode BN
    stay at rounding noise)."""
    params, state = perturbed
    rng = np.random.RandomState(5)
    x = (rng.randn(B, N, 32) * 0.5).astype(np.float32)
    idx = rng.randint(0, N, (B, N, 16))
    fp, fs, mp = (params["feat_convs"][1], state["feat_convs"][1],
                  params["merge_convs"][1])
    proj = rng.randn(B, N, mp["conv2"]["w"].shape[1]).astype(np.float32)

    def j_loss(p):
        f, _ = j_encoder.feature_extract_apply(
            p["f"], fs, jnp.asarray(x), jnp.asarray(idx), True)
        return jnp.mean(j_encoder.feat_merge_apply(p["m"], f) * proj)

    want = jax.grad(j_loss)({"f": fp, "m": mp})
    tp = _torch_tree({"f": fp, "m": mp}, grad=True)
    f, _ = t_encoder.feature_extract_apply(
        tp["f"], _torch_tree(fs), torch.from_numpy(x),
        torch.from_numpy(idx), train=True)
    torch.mean(t_encoder.feat_merge_apply(tp["m"], f)
               * torch.from_numpy(proj)).backward()
    _assert_grads_close(jax.tree.map(lambda t: t.grad.numpy(), tp), want)


def test_flow_gradients_match_jax(perturbed):
    """f with its log-density and the inverse flow g at perturbed
    weights, on fixed conditions: gradients of NLL + a projection of g."""
    params, _ = perturbed
    rng = np.random.RandomState(6)
    x = (rng.randn(B, N, 3) * 0.5).astype(np.float32)
    fz = (rng.randn(B, N, 3, R) * 0.5).astype(np.float32)
    cs = [(rng.randn(B, N, c) * 0.3).astype(np.float32)
          for c in t_discrete.COND_CHANNELS]
    proj = rng.randn(B, N * R, 3).astype(np.float32)
    blocks = {"flow_blocks": params["flow_blocks"]}

    def j_loss(p):
        j_cs = [jnp.asarray(c) for c in cs]
        _, nll = j_discrete.log_prob(p, jnp.asarray(x), j_cs)
        out = j_discrete.g_transform(p, jnp.asarray(fz), j_cs, R)
        return nll * 1e-2 + jnp.sum(out * proj)

    want = jax.grad(j_loss)(blocks)
    tp = _torch_tree(blocks, grad=True)
    t_cs = [torch.from_numpy(c) for c in cs]
    _, nll = t_discrete.log_prob(tp, torch.from_numpy(x), t_cs)
    out = t_discrete.g_transform(tp, torch.from_numpy(fz), t_cs, R)
    (nll * 1e-2 + torch.sum(out * torch.from_numpy(proj))).backward()
    _assert_grads_close(jax.tree.map(lambda t: t.grad.numpy(), tp), want)


def _optax_steps(grads_seq, lr):
    opt = j_trainer.make_optimizer(j_trainer.TrainConfig(learning_rate=lr))
    params = {"a": np.linspace(-1, 1, 50, dtype=np.float32),
              "b": np.arange(21, dtype=np.float32).reshape(7, 3) * 0.1}
    params = jax.tree.map(jnp.asarray, params)
    state = opt.init(params)
    out = []
    for g in grads_seq:
        ok = np.isfinite(g).all()
        tree = {"a": jnp.asarray(g[:50]),
                "b": jnp.asarray(g[50:].reshape(7, 3))}
        tree = jax.tree.map(lambda t: jnp.where(ok, t, 0.0), tree)
        updates, state = opt.update(tree, state, params)
        params = optax.apply_updates(params, updates)
        out.append(np.concatenate([np.asarray(params["a"]),
                                   np.asarray(params["b"]).reshape(-1)]))
    return out


def _port_steps(grads_seq, lr):
    opt = t_trainer.make_optimizer(t_trainer.TrainConfig(learning_rate=lr))
    params = torch.cat([torch.linspace(-1, 1, 50),
                        torch.arange(21, dtype=torch.float32) * 0.1])
    state = opt.init(params)
    out = []
    for g in grads_seq:
        g = torch.from_numpy(g)
        ok = torch.isfinite(g).all()
        updates, state = opt.update(torch.where(ok, g, 0.0), state)
        params = params + updates
        out.append(params.numpy().copy())
    return out, state


def test_clip_adam_matches_optax():
    """Three steps: under the clip threshold, over it, and a NaN step
    (zero gradients; Adam still steps on its moments)."""
    rng = np.random.RandomState(1)
    small = (rng.randn(71) * 1e-4).astype(np.float32)     # |g| < 1e-2
    large = (rng.randn(71) * 1.0).astype(np.float32)      # clipped
    bad = large.copy()
    bad[5] = np.nan
    assert np.linalg.norm(small) < 1e-2 < np.linalg.norm(large)
    seq = [small, large, bad]
    want = _optax_steps(seq, 1e-3)
    got, state = _port_steps(seq, 1e-3)
    assert state.count == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    # a NaN step first leaves the params bit-identical
    first, _ = _port_steps([bad], 1e-3)
    init, _ = _port_steps([np.zeros(71, np.float32)], 0.0)
    np.testing.assert_array_equal(first[0], init[0])


def _trainer(params, state, **kw):
    cfg = t_trainer.TrainConfig(emd_iters=EMD_ITERS, **kw)
    return t_trainer.Trainer(cfg, params, state, device="cpu")


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


def test_train_cli_then_upsample_on_cpu(tmp_path):
    from puflow_torch.cli import train_pu1k

    ckpt = str(tmp_path / "ck" / "m.npz")
    tr = train_pu1k.main(["--synthetic", "1", "--max_epochs", "1",
                          "--batch_size", "2", "--device", "cpu",
                          "--checkpoint", ckpt])
    assert len(tr.history) == 1 and tr.history[0]["steps"] == 1
    model = t_checkpoint.load_checkpoint(ckpt, device="cpu", fold=True)
    x = torch.from_numpy(t_synthetic_pairs(np.random.RandomState(1), 1, 64,
                                           R)[0])
    out = model(x, R)
    assert out.shape == (1, 64 * R, 3) and bool(torch.isfinite(out).all())
    assert (tmp_path / "ck" / "m-epoch1.npz").exists()
