"""The CNF family's data parallelism on the CPU: two `gloo` ranks spawned
by `torch_parallel_cases.run_ranks` (rank bodies in
tests/torch_parallel_cnf_cases.py, which import no jax) against one
process and against the JAX package on its 2-device virtual CPU mesh
(tests/conftest.py gives 8).

Under a JAX mesh the sharded jit solves the global batch with one dopri5
step size; the port's ranks exchange their error sums once an attempt and
add them in rank order (`parallel.rank_order_sum`), so every rank takes
the one-process run's steps: the same [attempted, accepted] in every
solve, and the ranks' results bit-equal to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.models import continuous as t_cont
from puflow_torch.models import discrete as t_discrete
from puflow_torch.ops import cnf as t_cnf
from puflow_tpu.checkpoint import _cnf_sample_fn
from puflow_tpu.inference.patch import (upsample_cloud_sharded as
                                        j_upsample_cloud_sharded)
from puflow_tpu.models import continuous as j_cont
from puflow_tpu.models import fold_bn as j_fold
from puflow_tpu.parallel.mesh import make_mesh
from torch_parallel_cases import run_ranks
from torch_parallel_cnf_cases import (cnf_eval_one_process, cnf_eval_rank,
                                      cnf_upsample_one_process,
                                      cnf_upsample_rank, decay_solve,
                                      masked_decay_rank, plain_solver_rank)
from torch_threads import one_torch_thread  # noqa: F401

W = 2


def _perturbed_cnf_trees(seed: int):
    """The JAX-initialised CNF model moved off the identity by
    `perturb_init` (tests/test_torch_cnf_model.py): the solves take 4 to 8
    steps with some rejected, where seeded weights clip every step."""
    params, state = j_cont.init(jax.random.PRNGKey(0))
    return t_discrete.perturb_init(jax.tree.map(np.array, params),
                                   jax.tree.map(np.array, state), seed)


def _chamfer(a, b) -> np.ndarray:
    """Chamfer distance of each cloud of ``a`` to the same cloud of ``b``."""
    d = ((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(-1)
    return d.min(2).mean(1) + d.min(1).mean(1)


def test_plain_solver_takes_the_global_batchs_steps(tmp_path):
    """`odeint_dopri5(group=)` on ``dy/dt = -k y`` over 8 rows whose rates
    differ a hundredfold: rank 0 holds the four slow rows, rank 1 the four
    stiff ones. Both ranks take the one-process solve's attempts and
    accepts and their rows agree with it to 1e-6, while rank 0's rows
    solved alone take fewer attempts: a rank-local error norm would fail
    this test. Again with all rows on rank 0 and none on rank 1, which
    adds 0 and joins every exchange. `rank_order_sum` gives both ranks the
    same bits, the sum of rank 0's value and rank 1's in that order."""
    rng = np.random.RandomState(0)
    k = np.array([0.3, 0.5, 0.7, 0.9, 30.0, 45.0, 60.0, 80.0], np.float32)
    y0 = rng.uniform(0.5, 1.5, (8, 3)).astype(np.float32)
    t1 = 0.8
    want, want_steps = decay_solve(k, y0, t1)
    _, alone_steps = decay_solve(k[:4], y0[:4], t1)
    assert alone_steps[0] < want_steps[0], (alone_steps, want_steps)
    ranks = run_ranks(plain_solver_rank, W, k, y0, t1,
                      [(0, 4, 8), (0, 8, 8)], tmp=tmp_path)
    for halves in zip(*(r["solves"] for r in ranks)):
        got = np.concatenate([y for y, _ in halves])
        for _, steps in halves:
            assert steps == want_steps
        np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(ranks[0]["sum"], ranks[1]["sum"])
    np.testing.assert_array_equal(
        ranks[0]["sum"], np.float32([0.1 * 1, 1e-8 * 3])
        + np.float32([0.1 * 2, 1e-8 * 4]))


def test_cnf_upsample_cloud_sharded_matches_one_process_and_jax(tmp_path):
    """`upsample_cloud_sharded` of the perturbed, BN-folded CNF model over
    2 ranks at tests/test_inference.py's shapes (8 clouds of 128 points,
    npoint 512, patches of 64): the ranks' outputs bit-equal; against the
    port's one-process `upsample_cloud` the same [attempted, accepted] in
    all 12 solves on both ranks and the model's predictions (the ranks'
    patches in rank order) within atol 1e-4, the `sample` gate of
    tests/test_torch_cnf_model.py; against JAX's `upsample_cloud_sharded`
    over a 2-device mesh with the CNF `sample_fn`, the repo's pipeline
    gate, Chamfer < 1.5e-3 a cloud.

    The ranks add their error sums in rank order, one process adds all
    rows in `torch.sum`'s order: the ratios differ by rounding, and so do
    the step sizes that follow them (the predictions by 5.4e-7 here). The
    merge's FPS takes other points from a few near-tied candidates, as in
    tests/test_torch_parallel.py against JAX: the merged clouds are held
    to the one-process run by Chamfer < 1e-4 a cloud (the pipeline gate of
    `chip_smoke.py:phase_main_path`) with at most 1% of the points beyond
    atol 1e-4 of their place (17 of 4,096 at these weights)."""
    params, state = _perturbed_cnf_trees(3)
    rng = np.random.RandomState(3)
    pc = rng.randn(8, 128, 3).astype(np.float32)
    pc /= np.linalg.norm(pc, axis=-1, keepdims=True)
    args = (pc, 512, 4, 64, 4.0)

    ranks = run_ranks(cnf_upsample_rank, W, params, state, *args,
                      tmp=tmp_path)
    np.testing.assert_array_equal(ranks[0]["out"], ranks[1]["out"])
    one = cnf_upsample_one_process(params, state, *args)
    assert len(one["steps"]) == 2 * t_cont.NUM_BLOCKS
    assert max(s[0] for s in one["steps"]) > 3   # not all clipped steps
    for r in ranks:
        assert r["steps"] == one["steps"]
    pred = np.concatenate([r["pred"] for r in ranks])
    err = np.abs(pred - one["pred"]).max()
    print(f"sharded CNF sample vs one process: max_abs_err {err:.3e}, "
          f"steps {one['steps']}")
    np.testing.assert_allclose(pred, one["pred"], atol=1e-4)
    got = ranks[0]["out"]
    assert got.shape == (8, 512, 3) and np.isfinite(got).all()
    assert (_chamfer(got, one["out"]) < 1e-4).all()
    moved = np.abs(got - one["out"]).max(-1) > 1e-4
    assert moved.mean() <= 0.01, moved.sum(1)

    jp, js = jax.tree.map(jnp.asarray, (params, state))
    mesh = make_mesh(jax.devices()[:W])
    want = np.asarray(j_upsample_cloud_sharded(
        mesh, (j_fold.fold_bn_inference(jp, js), js), jnp.asarray(pc),
        _cnf_sample_fn, *args[1:]))
    cd = _chamfer(got, want)
    print(f"sharded CNF upsample vs JAX: Chamfer a cloud {cd}")
    assert (cd < 1.5e-3).all(), cd


def test_cnf_forward_eval_with_a_group_matches_jax(tmp_path):
    """`continuous.forward(train=False, group=)` over 2 ranks, one cloud a
    rank (tests/torch_cnf_cases.py's batch of 2 clouds of 64 points, x4):
    the 12 solves' [attempted, accepted] equal the one-process run's on
    both ranks, the NLL is the same on both, and against JAX's
    `continuous.forward(train=False)` on the global batch the dense clouds
    lie within atol 1e-4 and the NLL within rtol 1e-5, the gates of
    tests/test_torch_cnf_nll.py."""
    params, state = _perturbed_cnf_trees(7)
    x = (np.random.RandomState(7).randn(2, 64, 3) * 0.3).astype(np.float32)
    ranks = run_ranks(cnf_eval_rank, W, params, state, x, 4, tmp=tmp_path)
    one = cnf_eval_one_process(params, state, x, 4)
    assert len(one["steps"]) == 2 * t_cont.NUM_BLOCKS
    for r in ranks:
        assert r["steps"] == one["steps"]
    assert ranks[0]["nll"] == ranks[1]["nll"]
    got = np.concatenate([r["x"] for r in ranks])

    jp, js = jax.tree.map(jnp.asarray, (params, state))
    forward = jax.jit(lambda p, s, xx: j_cont.forward(p, s, xx, 4,
                                                      train=False)[:2])
    rx, rnll = forward(jp, js, jnp.asarray(x))
    err = np.abs(got - np.asarray(rx)).max()
    print(f"forward(train=False, group=): max_abs_err {err:.3e}, nll "
          f"{ranks[0]['nll']:.6f} vs JAX {float(rnll):.6f}, one process "
          f"{one['nll']:.6f}")
    np.testing.assert_allclose(got, np.asarray(rx), atol=1e-4)
    np.testing.assert_allclose(ranks[0]["nll"], float(rnll), rtol=1e-5)
    np.testing.assert_allclose(got, one["x"], atol=1e-4)


def test_what_takes_no_group_refuses_one(tmp_path):
    """The per-attempt modes take CUDA tensors only: the solve's and the
    adjoint's refuse CPU tensors. The masked loop, which refused a group
    of more than one rank until CNF training went data parallel, takes
    one: `odeint_dopri5(differentiable=True, group=)` of `decay_field`
    over 2 ranks (rank 0 the four slow rows, rank 1 the four stiff ones,
    32 masked steps) gives the one-process solution to 1e-6, and the
    ranks' gradients of their rows' ``sum(y * w)`` with respect to the
    rates (each rank's through its own rows and, by the differentiable
    exchange, through the error norm of every row) add up to one
    process's within 1e-5 relative."""
    params, _ = t_cont.init(torch.Generator().manual_seed(0), device="cpu")
    layers = params["flow_blocks"][0]["layers"]
    c = torch.zeros((1, 8, layers[0]["hyper_gate"]["w"].shape[0] - 1))
    y = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        t_cnf.cnf_solve(layers, c, y, 0.5, per_attempt=True)
    with pytest.raises(ValueError, match="CUDA"):
        t_cnf.cnf_adjoint_bwd(layers, c, y, y, torch.zeros((1, 8, 1)), 0.5,
                              0.0, per_attempt=True)

    rng = np.random.RandomState(2)
    k = np.array([0.3, 0.5, 0.7, 0.9, 30.0, 45.0, 60.0, 80.0], np.float32)
    y0 = rng.uniform(0.5, 1.5, (8, 3)).astype(np.float32)
    w = rng.randn(8, 3).astype(np.float32)
    one = masked_decay_rank(None, k, y0, w, 0.2)
    ranks = run_ranks(masked_decay_rank, W, k, y0, w, 0.2, tmp=tmp_path)
    for r in ranks:
        assert r["steps"] == one["steps"]
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]),
                               one["y"], atol=1e-6)
    grad = ranks[0]["grad"] + ranks[1]["grad"]
    err = np.abs(grad - one["grad"]).max() / np.abs(one["grad"]).max()
    assert err < 1e-5, (grad, one["grad"])
