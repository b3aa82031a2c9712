"""The port's data parallelism (`puflow_torch.parallel`) on the CPU: two
`gloo` ranks spawned by `torch_parallel_cases.run_ranks` against one
process and against the JAX package on its 2-device virtual CPU mesh
(tests/conftest.py gives 8): global-batch BatchNorm, the discrete loss's
gradient (tests/test_train.py's function and gate), the trainer's steps
and NaN guard, and cloud-sharded upsampling (tests/test_inference.py's
shapes and gate). The ranks import no jax; the JAX side runs here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch import parallel
from puflow_torch.inference.patch import upsample_cloud as t_upsample_cloud
from puflow_torch.models import continuous as t_continuous
from puflow_torch.models import discrete as t_discrete
from puflow_torch.models.nn import bn_apply
from puflow_torch.train.trainer import TrainConfig, Trainer, TreeLayout
from puflow_tpu.data.synthetic import synthetic_pairs
from puflow_tpu.inference.patch import (upsample_cloud_sharded as
                                        j_upsample_cloud_sharded)
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.ops.emd import emd_auction as j_emd_auction
from puflow_tpu.parallel.mesh import make_mesh
from torch_parallel_cnf_cases import (cnf_forward_train,
                                      cnf_forward_train_rank)
from torch_parallel_cases import (EMD_ITERS, bn_rank, grad_rank, run_ranks,
                                  seeded_first_step, trainer_rank,
                                  upsample_rank)
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import _assert_grads_close

W = 2
CPU_GROUP = parallel.Group(0, W, torch.device("cpu"), "gloo")


def _jax_trees():
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    return (jax.tree.map(np.array, params), jax.tree.map(np.array, state))


def test_bn_apply_with_a_group_is_the_whole_batch(tmp_path):
    """Train-mode BN over 2 ranks: each rank's outputs, the new running
    statistics and the input gradient (of a loss summed over the ranks)
    equal one process's on the whole batch within 1e-6."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 5, 8) * 2.0 + 0.5).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
              "bias": rng.randn(8).astype(np.float32)}
    state = {"mean": rng.randn(8).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    xt = torch.from_numpy(x).requires_grad_()
    p, s = ({k: torch.from_numpy(v) for k, v in tree.items()}
            for tree in (params, state))
    y, new_state = bn_apply(p, s, xt, train=True)
    (g,) = torch.autograd.grad(torch.sum(y * torch.from_numpy(cot)), xt)
    ranks = run_ranks(bn_rank, W, params, state, x, cot, tmp=tmp_path)
    for k in ("mean", "var"):
        for r in ranks:
            np.testing.assert_allclose(r["state"][k],
                                       new_state[k].detach().numpy(),
                                       atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]),
                               y.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["grad"] for r in ranks]),
                               g.numpy(), atol=1e-6)


def test_dp_gradient_matches_the_jax_mesh_and_one_process(tmp_path):
    """The discrete loss's gradient over 2 ranks at one cloud a rank
    against the JAX package's gradient on a 2-device mesh
    (tests/test_train.py's loss and gate, ``5e-4 * scale + 1e-6`` per
    leaf) and against the port's one-process gradient."""
    params, state = _jax_trees()
    sparse, dense = synthetic_pairs(np.random.RandomState(1), W, 48, 4)

    def loss_fn(p, s, sp, de):
        pred, logpx, _ = j_discrete.forward(p, s, sp, 4, train=True)
        emd = jnp.sum(j_emd_auction(pred, de, 0.005, EMD_ITERS)[0])
        return logpx * 1e-4 + emd * 5e-2

    mesh = make_mesh(jax.devices()[:W])
    rep, bsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    j_grads = jax.jit(jax.grad(loss_fn), in_shardings=(rep, rep, bsh, bsh),
                      out_shardings=rep)(params, state, jnp.asarray(sparse),
                                         jnp.asarray(dense))
    j_grads = jax.tree.map(np.asarray, j_grads)

    ranks = run_ranks(grad_rank, W, params, state, sparse, dense,
                      tmp=tmp_path)
    np.testing.assert_array_equal(ranks[0]["grads"], ranks[1]["grads"])
    layout = TreeLayout(params)
    dp = layout.numpy_tree(torch.from_numpy(ranks[0]["grads"]))
    _assert_grads_close(dp, j_grads)
    one, loss = Trainer(TrainConfig(emd_iters=EMD_ITERS), params, state,
                        device="cpu").gradient(sparse, dense)
    _assert_grads_close(dp, layout.numpy_tree(one))
    np.testing.assert_allclose(ranks[0]["loss"], float(loss),
                               rtol=1e-5)


def test_dp_trainer_steps_stay_bit_equal_and_skip_nan(tmp_path):
    """The data-parallel `Trainer` over 2 ranks: a batch with a NaN in rank
    1's shard trips the NaN guard on both ranks (a first step, so Adam
    moves nothing: parameters and BN state unchanged); the next two steps
    leave the parameters bit-equal across ranks; the metrics and
    `validate` are the same on both and agree with one process's."""
    rng = np.random.RandomState(5)
    batches = [synthetic_pairs(rng, W, 32, 4) for _ in range(3)]
    params, state = seeded_first_step(batches[1][0])
    nan_sparse = batches[0][0].copy()
    nan_sparse[1, 3, 0] = np.nan                 # rank 1's shard
    val = [synthetic_pairs(rng, W, 32, 4)]
    ranks = run_ranks(trainer_rank, W, params, state,
                      (nan_sparse, batches[0][1]), batches[1:], val,
                      tmp=tmp_path)
    layout, state_layout = TreeLayout(params), TreeLayout(state)
    p0 = layout.flatten(params).numpy()
    s0 = state_layout.flatten(state).numpy()
    for r in ranks:
        first = r["steps"][0]
        assert first["metrics"]["nan_step"] == 1.0
        assert not np.isfinite(first["metrics"]["loss"])
        np.testing.assert_array_equal(first["params"], p0)
        np.testing.assert_array_equal(first["bn_state"], s0)
        for s in r["steps"][1:]:
            assert s["metrics"]["nan_step"] == 0.0
            assert np.isfinite(s["metrics"]["loss"])
    for a, b in zip(ranks[0]["steps"], ranks[1]["steps"]):
        np.testing.assert_array_equal(a["params"], b["params"])
        np.testing.assert_array_equal(a["bn_state"], b["bn_state"])
        assert a["metrics"] == pytest.approx(b["metrics"], nan_ok=True, abs=0)
    assert not np.array_equal(ranks[0]["steps"][-1]["params"], p0)
    assert ranks[0]["validate"] == ranks[1]["validate"]

    # one process: the first real step's loss at the same weights, and
    # validation at the trained weights
    one = Trainer(TrainConfig(emd_iters=EMD_ITERS), params, state,
                  device="cpu")
    _, loss = one.gradient(*batches[1])
    assert ranks[0]["steps"][1]["metrics"]["loss"] == pytest.approx(
        float(loss), rel=1e-5)
    last = ranks[0]["steps"][-1]
    trained = Trainer(TrainConfig(emd_iters=EMD_ITERS),
                      layout.numpy_tree(torch.from_numpy(last["params"])),
                      state_layout.numpy_tree(
                          torch.from_numpy(last["bn_state"])), device="cpu")
    want = trained.validate(val)
    for k in ("CD", "vloss"):
        assert ranks[0]["validate"][k] == pytest.approx(want[k], rel=1e-5)


def test_upsample_cloud_sharded_matches_jax_and_one_process(tmp_path):
    """Cloud-sharded upsampling over 2 ranks at tests/test_inference.py's
    shapes (8 clouds of 128 points, npoint 512, patches of 64): the two
    ranks' outputs and the port's one-process `upsample_cloud` bit-equal
    (tests/test_inference.py holds JAX's sharded run to its one-device run
    at atol 2e-4), and against JAX's `upsample_cloud_sharded` over 2
    devices the repo's cross-framework pipeline gate, Chamfer < 1.5e-3 a
    cloud (tests/test_torch_pipeline.py), with every point at its place
    within atol 2e-4 but those the merge's FPS takes from near-ties.

    The two frameworks' patch predictions differ by rounding (1e-6 here),
    which reorders a few of the union merge's near-tied candidates (relative
    margins of 1e-5 at 8 clouds; on one union both pick the same points):
    5 of 4,096 points are taken elsewhere at these weights (the gate: 1%).
    The weights are perturbed (`perturb_init`, as in
    tests/test_torch_pipeline.py): seeded init leaves the flows near the
    identity."""
    params, state = t_discrete.perturb_init(*_jax_trees(), 3)
    rng = np.random.RandomState(3)
    pc = rng.randn(8, 128, 3).astype(np.float32)
    pc /= np.linalg.norm(pc, axis=-1, keepdims=True)

    def sample_fn(mp_, patches, r):
        p, s = mp_
        return j_discrete.sample(p, s, patches, r)

    mesh = make_mesh(jax.devices()[:W])
    want = np.asarray(j_upsample_cloud_sharded(
        mesh, (params, state), jnp.asarray(pc), sample_fn, 512, 4, 64, 4.0))
    ranks = run_ranks(upsample_rank, W, params, state, pc, 512, 4, 64, 4.0,
                      tmp=tmp_path)
    np.testing.assert_array_equal(ranks[0], ranks[1])
    got = ranks[0]
    assert got.shape == want.shape == (8, 512, 3)
    model = t_checkpoint.from_numpy_tree(params, state, "cpu")
    with torch.no_grad():
        one = t_upsample_cloud(model, torch.from_numpy(pc), 512, 4, 64, 4.0)
    np.testing.assert_array_equal(got, one.numpy())

    d = ((got[:, :, None, :] - want[:, None, :, :]) ** 2).sum(-1)
    cd = d.min(2).mean(1) + d.min(1).mean(1)
    assert (cd < 1.5e-3).all(), cd
    moved = np.abs(got - want).max(-1) > 2e-4           # [8, 512]
    assert moved.mean() <= 0.01, moved.sum(1)


def test_the_continuous_family_is_refused(tmp_path):
    """Nothing of the CNF family's training is refused over more than one
    rank any more: the data-parallel trainer takes `continuous.forward`
    (tests/test_torch_parallel_cnf_train.py trains with it), and
    `continuous.forward(train=True, group=)` over 2 ranks at 16 points a
    cloud gives both ranks one process's NLL within 1e-5 relative (the
    global batch's mean) and new BN state within 1e-6 (global-batch
    statistics), and the ranks' parts of the NLL's gradient (each rank's
    of NLL / W, as the trainer weights the global NLL every rank holds)
    add up to one process's within ``1e-4 * scale + 1e-6`` a leaf (tests/test_train.py's
    form of gate, scale the leaf's largest entry and at least 1e-3: the
    biases before train-mode BN have a zero gradient but for rounding)."""
    params, state = jax.tree.map(
        lambda t: t.numpy(),
        t_continuous.init(torch.Generator().manual_seed(0), device="cpu"))
    x = (np.random.RandomState(6).randn(W, 16, 3) * 0.3).astype(np.float32)
    one = cnf_forward_train(params, state, x, 4)
    ranks = run_ranks(cnf_forward_train_rank, W, params, state, x, 4,
                      tmp=tmp_path)
    assert ranks[0]["nll"] == ranks[1]["nll"]
    np.testing.assert_allclose(ranks[0]["nll"], one["nll"], rtol=1e-5)
    for r in ranks:
        for got, want in zip(r["bn"], one["bn"], strict=True):
            np.testing.assert_allclose(got, want, atol=1e-6)
    for i, want in enumerate(one["grads"]):
        scale = max(np.abs(want).max(), 1e-3)
        np.testing.assert_allclose(ranks[0]["grads"][i] + ranks[1]["grads"][i],
                                   want, atol=1e-4 * scale + 1e-6,
                                   err_msg=str(i))


def test_shard_batch_lays_rows_out_as_a_batch_sharding():
    """Rank r of W takes rows [r B / W, (r + 1) B / W); a batch that does
    not split evenly raises."""
    x = np.arange(12).reshape(6, 2)
    for r in range(3):
        g = parallel.Group(r, 3, torch.device("cpu"), "gloo")
        np.testing.assert_array_equal(parallel.shard_batch(x, g),
                                      x[2 * r:2 * r + 2])
    assert parallel.shard_batch(x, None) is x
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch(x[:5], CPU_GROUP)
    with pytest.raises(ValueError, match="nccl"):
        parallel.init_group("nccl", 0, 1, "cpu")
