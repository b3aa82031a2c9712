"""The CNF family's data-parallel training on the CPU: two `gloo` ranks
spawned by `torch_parallel_cases.run_ranks` (rank bodies in
tests/torch_parallel_cnf_cases.py, which import no jax) against one
process and against the JAX package's gradient on its 2-device virtual
CPU mesh (tests/conftest.py gives 8).

Under a JAX mesh every dopri5 step of a train step is judged on the whole
augmented state of the global batch; in the backward solves that state
holds the replicated parameters' cotangent G once. The port's ranks each
accumulate their own rows' part of G: their error norm adds the parts in
rank order, forms each entry's ratio from the sums and counts G once
(`models.ode._error_ratio`), and each rank returns its part, which the
trainer's one gradient all-reduce adds. The sizes are those of
tests/test_torch_cnf_train.py (B = 2, one cloud a rank, 64 points, x4, 5
auction iterations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from puflow_torch.models import continuous as t_cont
from puflow_torch.models.ode import _error_ratio
from puflow_torch.train.trainer import TreeLayout
from puflow_tpu.data.synthetic import synthetic_pairs
from puflow_tpu.models import continuous as j_cont
from puflow_tpu.ops.emd import emd_auction as j_emd_auction
from puflow_tpu.parallel.mesh import make_mesh
from torch_parallel_cases import run_ranks
from torch_parallel_cnf_cases import (chain_rank, cnf_grad, cnf_grad_rank,
                                      cnf_trainer, cnf_trainer_rank,
                                      decay_adjoint, decay_adjoint_rank,
                                      error_ratio_rank, moving_bn_rank)
from torch_threads import one_torch_thread  # noqa: F401

W = 2
B, N, R, EMD_ITERS = 2, 64, 4, 5
ROUNDING_ZERO = 1e-4


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
    """The bias leaves before train-mode BN, whose true gradient is zero
    (tests/test_torch_cnf_train.py)."""
    peak = {n: float(np.abs(g).max()) for n, g in grads.items()}
    return {n for n in grads if n.endswith("/b") and n[:-1] + "w" in peak
            and peak[n] < ROUNDING_ZERO * peak[n[:-1] + "w"]}


def _assert_cnf_grads_close(got: dict, want: dict, tol: float) -> float:
    """tests/test_torch_cnf_train.py's gate: every leaf finite, the same
    rounding-zero biases on both sides (none a CNF block's), every other
    leaf within ``tol`` max-relative. -> the worst relative error."""
    assert got.keys() == want.keys()
    assert all(np.isfinite(g).all() for g in got.values())
    zero = _rounding_zero(want)
    assert zero == _rounding_zero(got)
    assert not [n for n in zero if n.startswith("/flow_blocks/")]
    rels = {n: _maxrel(got[n], want[n]) for n in want if n not in zero}
    assert len(rels) > len(want) // 2
    worst = max(rels, key=rels.get)
    assert rels[worst] < tol, (worst, rels[worst])
    return rels[worst]


def _jax_trees():
    params, state = j_cont.init(jax.random.PRNGKey(0))
    return (jax.tree.map(np.array, params), jax.tree.map(np.array, state))


def test_error_ratio_counts_a_replicated_leaf_once(tmp_path):
    """`_error_ratio` over 2 ranks of a state with a row leaf (16 rows,
    split) and a replicated leaf of 50 entries, each rank holding a part
    (0.3 and 0.7 of it): the one-process ratio of the whole batch, with
    the whole leaf, to float rounding, and the same bits on both ranks.
    The same leaf taken as sharded (each rank's sum and count added) is
    the count trap: its ratio is off by 23% here."""
    rng = np.random.RandomState(0)
    rows = [(rng.randn(16, 3) * s).astype(np.float32) for s in (1e-5, 1, 1)]
    whole = [(rng.randn(50) * s).astype(np.float32) for s in (1e-5, 1, 1)]
    parts = [[np.float32(f) * g for g in whole] for f in (0.3, 0.7)]
    # the parts sum to the leaf to rounding: take their float sum as it
    whole = [a + b for a, b in zip(*parts)]
    want = float(_error_ratio(
        *([torch.from_numpy(r), torch.from_numpy(g)]
          for r, g in zip(rows, whole)), 1e-5, 1e-5))
    ranks = run_ranks(error_ratio_rank, W, rows, parts, tmp=tmp_path)
    assert ranks[0]["ratio"] == ranks[1]["ratio"]
    np.testing.assert_allclose(ranks[0]["ratio"], want, rtol=1e-6)
    assert abs(ranks[0]["unmarked"] / want - 1) > 0.1, ranks


def test_adjoint_backward_with_a_group_takes_the_global_batchs_steps(
        tmp_path):
    """`adjoint_backward(group=)` on ``dy/dt = -s k y`` with the rates k
    (one a row) and the scale s replicated, 8 rows whose rates differ
    twentyfold, rank 0 holding the four slow rows and rank 1 the four
    stiff ones (tests/test_torch_parallel_cnf.py's plain-solver split):
    both ranks take the one-process run's [attempted, accepted] (10
    steps) where rank 0's rows alone take 3, the ranks' summed parameter
    cotangent (in rank order: the same bits on both) is the one-process
    one within 1e-6 relative, and their rows' y0 and a0 agree with it
    within 1e-6 relative. (Stiffer rows make y grow by e^10 back to 0,
    where the two runs' rounding moves the cotangent by 5e-6.)"""
    rng = np.random.RandomState(1)
    k = np.array([0.3, 0.5, 0.7, 0.9, 3.0, 4.0, 5.0, 6.0], np.float32)
    y1 = rng.uniform(0.5, 1.5, (8, 3)).astype(np.float32)
    a1 = rng.randn(8, 3).astype(np.float32)
    one = decay_adjoint(k, 1.3, y1, a1, 0.5)
    alone = decay_adjoint(k[:4], 1.3, y1[:4], a1[:4], 0.5)
    assert alone["steps"][0] < one["steps"][0] < 128, (alone, one)
    ranks = run_ranks(decay_adjoint_rank, W, k, 1.3, y1, a1, 0.5,
                      tmp=tmp_path)
    for r in ranks:
        assert r["steps"] == one["steps"]
    np.testing.assert_array_equal(ranks[0]["g_sum"], ranks[1]["g_sum"])
    assert _maxrel(ranks[0]["g_sum"], one["g_sum"]) < 1e-6
    for key in ("y0", "a0"):
        np.testing.assert_allclose(
            np.concatenate([r[key] for r in ranks]), one[key], rtol=1e-6,
            atol=1e-7)
    # each rank's part of k's cotangent is its own rows'
    assert not ranks[0]["g"]["k"][4:].any()
    assert not ranks[1]["g"]["k"][:4].any()


def test_moving_bn_with_a_group_is_the_whole_batch(tmp_path):
    """`moving_bn_forward(train=True, group=)` over 2 ranks: the outputs,
    the log-density, the new running statistics (the global batch's mean
    and unbiased variance, as JAX's sharded jit takes them) and the input
    gradient of a loss summed over the ranks equal one process's on the
    whole batch within 1e-6."""
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 10, 3) * 1.5 + 0.3).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    params = {"weight": rng.randn(3).astype(np.float32) * 0.1,
              "bias": rng.randn(3).astype(np.float32)}
    state = {"mean": rng.randn(3).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 3).astype(np.float32),
             "step": np.zeros(1, np.float32)}
    one = moving_bn_rank(None, params, state, x, cot)
    ranks = run_ranks(moving_bn_rank, W, params, state, x, cot, tmp=tmp_path)
    for key in ("y", "logpx", "grad"):
        np.testing.assert_allclose(
            np.concatenate([r[key] for r in ranks]), one[key], atol=1e-6,
            err_msg=key)
    for r in ranks:
        for key, v in one["state"].items():
            np.testing.assert_allclose(r["state"][key], v, atol=1e-6,
                                       err_msg=key)


def test_sequential_flow_apply_with_a_group_is_the_whole_batch(tmp_path):
    """`sequential_flow_apply(train=True, group=)` of a seeded chain with
    moving-BNs (bn, (cnf, bn) x 2, conditions of 8) over 2 ranks: the
    flowed points and log-densities equal one process's within 1e-5, the
    running statistics within 1e-6, and the ranks' parameter gradients
    (the BNs' through the differentiable all-reduce, the CNF layers'
    from the adjoint's rank parts) summed over the ranks match one
    process's within 1e-4 relative a leaf."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 12, 3) * 0.5).astype(np.float32)
    c = (rng.randn(2, 12, 8) * 0.5).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    one = chain_rank(None, 4, x, c, cot)
    ranks = run_ranks(chain_rank, W, 4, x, c, cot, tmp=tmp_path)
    for key, tol in (("x", 1e-5), ("logpx", 1e-5)):
        np.testing.assert_allclose(
            np.concatenate([r[key] for r in ranks]), one[key], atol=tol,
            err_msg=key)
    for r in ranks:
        for got, want in zip(r["state"], one["state"]):
            for key in (want or {}):
                np.testing.assert_allclose(got[key], want[key], atol=1e-6)
    for i, want in enumerate(one["grads"]):
        got = ranks[0]["grads"][i] + ranks[1]["grads"][i]
        assert _maxrel(got, want) < 1e-4, (i, _maxrel(got, want))


def test_cnf_gradient_with_a_group_matches_the_jax_mesh_and_one_process(
        tmp_path):
    """The CNF loss's gradient (``1e-4 NLL + 5e-2 EMD``) through
    `continuous.forward(train=True, group=)` on 2 ranks, one cloud a rank,
    at a first step's weights (seeded init): the ranks' reduced gradients
    bit-equal, and against `jax.grad` of the same loss under a 2-device
    mesh (batch sharded, parameters replicated) at
    tests/test_torch_cnf_train.py's gate (2e-2 max-relative a leaf but the
    rounding-zero biases); against the port's one-process gradient the
    same gate, the same [attempted, accepted] in all 24 solves (12
    forward, 12 backward) on both ranks, and the loss within 1e-5."""
    params, state = _jax_trees()
    sparse, dense = synthetic_pairs(np.random.RandomState(3), B, N, R)

    def loss_fn(p, s, sp, de):
        pred, logpx, _ = j_cont.forward(p, s, sp, R, train=True)
        emd = jnp.sum(j_emd_auction(pred, de, 0.005, EMD_ITERS)[0])
        return logpx * 1e-4 + emd * 5e-2

    mesh = make_mesh(jax.devices()[:W])
    rep, bsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    j_grads = jax.jit(jax.grad(loss_fn), in_shardings=(rep, rep, bsh, bsh),
                      out_shardings=rep)(params, state, jnp.asarray(sparse),
                                         jnp.asarray(dense))
    want = dict(_leaf_items(jax.tree.map(np.asarray, j_grads)))

    ranks = run_ranks(cnf_grad_rank, W, params, state, sparse, dense,
                      EMD_ITERS, tmp=tmp_path)
    np.testing.assert_array_equal(ranks[0]["grads"], ranks[1]["grads"])
    one = cnf_grad(cnf_trainer(params, state, emd_iters=EMD_ITERS), sparse,
                   dense)
    assert len(one["steps"]) == 4 * t_cont.NUM_BLOCKS
    for r in ranks:
        assert r["steps"] == one["steps"]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    layout = TreeLayout(params)

    def tree(flat):
        return dict(_leaf_items(layout.numpy_tree(torch.from_numpy(flat))))

    got = tree(ranks[0]["grads"])
    worst = _assert_cnf_grads_close(got, want, 2e-2)
    worst_one = _assert_cnf_grads_close(got, tree(one["grads"]), 2e-2)
    print(f"2-rank CNF gradient: worst leaf {worst:.3e} against the JAX "
          f"mesh, {worst_one:.3e} against one process; steps "
          f"{one['steps']}")


def test_cnf_trainer_with_a_group_steps_bit_equal_and_validates(tmp_path):
    """`Trainer(..., forward_fn=continuous.forward, group=)` over 2 ranks:
    after each of two steps the ranks' parameters and BN state are
    bit-equal, the
    metrics the same on both, and the first step's loss within 1e-5 of
    one process's; `validate` with the group gives one process's NLL
    within rtol 1e-5 (every validation solve takes the global batch's
    steps) and its chamfer within 1e-6."""
    params, state = _jax_trees()
    rng = np.random.RandomState(4)
    batches = [synthetic_pairs(rng, B, 32, R) for _ in range(2)]
    val = [synthetic_pairs(rng, B, 32, R)]
    ranks = run_ranks(cnf_trainer_rank, W, params, state, batches, val,
                      EMD_ITERS, tmp=tmp_path)
    for a, b in zip(ranks[0]["steps"], ranks[1]["steps"]):
        np.testing.assert_array_equal(a["params"], b["params"])
        np.testing.assert_array_equal(a["bn_state"], b["bn_state"])
        assert a["metrics"] == b["metrics"]
        assert not a["metrics"]["nan_step"]
    assert ranks[0]["validate"] == ranks[1]["validate"]
    tr = cnf_trainer(params, state, emd_iters=EMD_ITERS)
    m = tr.step(*batches[0])
    np.testing.assert_allclose(ranks[0]["steps"][0]["metrics"]["loss"],
                               float(m["loss"]), rtol=1e-5)
    one = cnf_trainer(params, state, emd_iters=EMD_ITERS)
    one.params = torch.from_numpy(ranks[0]["steps"][-1]["params"])
    one.bn_state = torch.from_numpy(ranks[0]["steps"][-1]["bn_state"])
    want = one.validate(val)
    got = ranks[0]["validate"]
    np.testing.assert_allclose(got["vloss"], want["vloss"], rtol=1e-5)
    np.testing.assert_allclose(got["CD"], want["CD"], atol=1e-6)
