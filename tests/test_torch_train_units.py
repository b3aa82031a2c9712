"""The discrete training path's parts that need no model weights, against
puflow_tpu's on the CPU: train-mode BatchNorm, the prior, the clip + Adam
arithmetic against optax's chain, and the train CLI on a tiny synthetic
set whose checkpoint then upsamples. Shared cases:
tests/torch_train_cases.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.data.synthetic import synthetic_pairs as t_synthetic_pairs
from puflow_torch.models import nn as t_nn
from puflow_torch.train import trainer as t_trainer
from puflow_tpu.models import nn as j_nn
from puflow_tpu.train import trainer as j_trainer
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import R


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
