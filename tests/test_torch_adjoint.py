"""The port's CNF gradients against puflow_tpu on the CPU.

The masked fixed-trip driver, the continuous adjoint, the differentiable
flow blocks and the plain versions of the two training kernels go through
the JAX functions and their counterparts on the same numpy-seeded inputs
(the whole ``continuous.forward(train=True)``:
`tests/test_torch_adjoint_model.py`). Sizes and tolerances are
those of `tests/test_cnf.py`: gradients on 1 x 8 points (values within
1e-4, gradients within 2e-2 relative), the Pallas kernels in interpret
mode at B = 1, N = 60 (2e-3 max-relative for the adjoint, 5e-6 for the
log-density solve, 5e-5 for the boundary fields).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.models import continuous as t_cont
from puflow_torch.models.ode import make_adjoint_odeint
from puflow_torch.models.ode import odeint_dopri5 as t_odeint
from puflow_torch.ops import cnf as t_cnf
from puflow_tpu.models import continuous as j_cont
from puflow_tpu.models.ode import odeint_dopri5 as j_odeint
from puflow_tpu.ops.pallas.cnf_adjoint_pallas import cnf_adjoint_bwd_pallas
from puflow_tpu.ops.pallas.cnf_pallas import cnf_solve_logp_pallas
from torch_threads import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)


def _to_torch(tree, grad=False):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)).requires_grad_(grad), tree)


def _maxrel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


def _tree_maxrel(got, ref) -> float:
    return max(_maxrel(g.detach().numpy(), r)
               for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)))


def _rand(seed, *shape, scale=0.4):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# --------------------------------------------------------------------------
# the masked driver and the adjoint
# --------------------------------------------------------------------------
A = np.array([[-0.5, -3.0, 0.0], [3.0, -0.5, 0.0], [0.0, 0.0, -4.0]],
             np.float32)


@pytest.mark.parametrize("t0,t1", [(0.0, 1.3), (1.3, 0.0)])
def test_masked_driver_matches_jax(t0, t1):
    """Value and gradients (matrix, start state, both end times) of the
    fixed-trip loop against `jax.grad` through JAX's. Both take the same
    steps in float32: measured 6e-8 on the value and 4e-7 relative on the
    gradients; held to 1e-5 and 1e-4."""
    y0 = np.array([[1.0, 0.0, 2.0], [0.3, -0.7, 1.0]], np.float32)

    def j_loss(w, y, a, b):
        out = j_odeint(lambda t, s: jnp.tanh(s) @ w.T + jnp.sin(3 * t), y,
                       a, b, 1e-5, 1e-5, 128, differentiable=True)
        return jnp.sum(out ** 2)

    rv, rg = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(A), jnp.asarray(y0), jnp.float32(t0), jnp.float32(t1))
    w = torch.tensor(A, requires_grad=True)
    y = torch.tensor(y0, requires_grad=True)
    a = torch.tensor(t0, requires_grad=True)
    b = torch.tensor(t1, requires_grad=True)
    out, stats = t_odeint(lambda t, s: torch.tanh(s) @ w.T
                          + torch.sin(3 * t), y, a, b, return_stats=True)
    loss = torch.sum(out ** 2)
    grads = torch.autograd.grad(loss, (w, y, a, b))
    assert 3 < stats["steps"] < 128
    assert abs(float(loss) - float(rv)) <= 1e-5 * abs(float(rv))
    for g, r in zip(grads, rg):
        assert _maxrel(g.numpy(), r) < 1e-4


def test_masked_driver_matches_early_exit_and_stops():
    """The masked loop ends where the early-exit loop ends, and its step
    count stops growing once the solve is done."""
    f = (lambda t, y: y @ torch.from_numpy(A).T)
    y0 = torch.tensor([[1.0, 0.0, 2.0]])
    ref, rst = t_odeint(f, y0, 0.0, 1.3, differentiable=False,
                        return_stats=True)
    got, gst = t_odeint(f, y0, 0.0, 1.3, max_steps=64, return_stats=True)
    assert gst["steps"] == rst["steps"]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def test_adjoint_solver_hooks():
    """`make_adjoint_odeint`'s forward and backward hooks: a backward
    solver that returns ``(y0, a0, g)`` leaves the boundary cotangents to
    the adjoint, one that returns them too is taken as it is; both give
    the plain adjoint's gradients."""
    from puflow_torch.models.ode import adjoint_backward

    def func(p, t, y):
        return torch.tanh(y) @ p["w"].T + torch.sin(3 * t)

    def bwd3(p, y1, y1_bar, t0, t1):
        return adjoint_backward(func, p, y1, y1_bar, t1, t0)

    def bwd5(p, y1, y1_bar, t0, t1):
        y0, a0, g = bwd3(p, y1, y1_bar, t0, t1)
        return (y0, a0, g, -torch.sum(a0 * func(p, t0, y0)),
                torch.sum(y1_bar * func(p, t1, y1)))

    def fwd(p, y0, t0, t1):
        return t_odeint(lambda t, y: func(p, t, y), y0, t0, t1,
                        differentiable=False)

    grads = []
    for hooks in ({}, {"bwd_solver": bwd3}, {"fwd_solver": fwd,
                                             "bwd_solver": bwd5}):
        w = torch.tensor(A, requires_grad=True)
        y0 = torch.tensor([[1.0, 0.0, 2.0]], requires_grad=True)
        t1 = torch.tensor(1.3, requires_grad=True)
        out = make_adjoint_odeint(func, **hooks)({"w": w}, y0, 0.0, t1)
        grads.append(torch.autograd.grad(torch.sum(out ** 2), (w, y0, t1)))
    for other in grads[1:]:
        for g, r in zip(other, grads[0]):
            torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)


def _block_inputs(cdim=32):
    params, _ = j_cont.init(KEY)
    block = jax.tree.map(np.asarray, params["flow_blocks"][0])
    return block, _rand(1, 1, 8, 3), _rand(2, 1, 8, cdim)


def test_adjoint_matches_masked_driver():
    """`make_adjoint_odeint` on the exact-trace field against autograd
    through the masked driver (`tests/test_cnf.py:166-192`): value within
    1e-4, gradients within 2e-2 relative."""
    block, x, c = _block_inputs()
    layers = _to_torch(block["layers"], grad=True)
    xt, ct = torch.tensor(x), torch.tensor(c)
    T = torch.tensor(float(block["sqrt_end_time"]) ** 2, requires_grad=True)
    logp0 = torch.zeros((1, 8, 1))
    field = t_cont.exact_div_field()
    # seeded blocks take three steps: a budget of 16 keeps the masked
    # loop's graph small
    solve = make_adjoint_odeint(field, max_steps=16)
    leaves = jax.tree.leaves(layers) + [T]

    def loss_of(z, logp):
        return torch.sum(z ** 2) + torch.sum(logp)

    z, logp = solve({"layers": layers, "c": ct}, (xt, logp0), 0.0, T)
    la = loss_of(z, logp)
    ga = torch.autograd.grad(la, leaves)
    (z, logp), stats = t_odeint(
        lambda t, s: field({"layers": layers, "c": ct}, t, s), (xt, logp0),
        0.0, T, max_steps=16, return_stats=True)
    assert stats["steps"] < 16
    ls = loss_of(z, logp)
    gs = torch.autograd.grad(ls, leaves)
    assert abs(float(la) - float(ls)) < 1e-4
    assert max(_maxrel(a.numpy(), b.numpy()) for a, b in zip(ga, gs)) < 2e-2


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_flow_block_gradients_match_jax(direction):
    """`flow_block_forward` / `flow_block_inverse(differentiable=True)`:
    the loss and its gradients in every layer leaf, ``sqrt_end_time``, the
    points and the conditions against `jax.value_and_grad` of the same
    loss (`tests/test_cnf.py:166-192`, `:339-367`): 1e-4 and 2e-2."""
    block, x, c = _block_inputs()

    def j_loss(blk, xx, cc):
        if direction == "forward":
            z, logp = j_cont.flow_block_forward(blk, xx, cc,
                                                differentiable=True)
            return jnp.sum(z ** 2) + jnp.sum(logp)
        return jnp.sum(j_cont.flow_block_inverse(blk, xx, cc,
                                                 differentiable=True) ** 2)

    rv, rg = jax.value_and_grad(j_loss, argnums=(0, 1, 2))(
        block, jnp.asarray(x), jnp.asarray(c))
    tb = _to_torch(block, grad=True)
    xt = torch.tensor(x, requires_grad=True)
    ct = torch.tensor(c, requires_grad=True)
    if direction == "forward":
        z, logp = t_cont.flow_block_forward(tb, xt, ct)
        loss = torch.sum(z ** 2) + torch.sum(logp)
    else:
        loss = torch.sum(t_cont.flow_block_inverse(
            tb, xt, ct, differentiable=True) ** 2)
    leaves = jax.tree.leaves(tb)
    grads = torch.autograd.grad(loss, leaves + [xt, ct])
    assert abs(float(loss) - float(rv)) < 1e-4
    ref = jax.tree.leaves(rg[0]) + [rg[1], rg[2]]
    rels = [_maxrel(g.numpy(), r) for g, r in zip(grads, ref)]
    assert max(rels) < 2e-2, rels
    # the end time (the block's last leaf) has a gradient, not zero
    assert float(grads[len(leaves) - 1].abs()) > 0


def test_training_solves_routes_the_differentiable_solves():
    """Inside `continuous.training_solves` a differentiable block's solves,
    forward and backward, go through the given functions (here counting
    spies around the plain versions), and give what the wrappers give on
    the CPU; outside it they go through the wrappers again."""
    block, x, c = _block_inputs()
    calls = {"logp": 0, "solve": 0, "adjoint": 0}

    def spy(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    solves = (spy("logp", t_cnf.cnf_solve_logp_plain),
              spy("solve", t_cnf.cnf_solve_plain),
              spy("adjoint", t_cnf.cnf_adjoint_bwd_plain))

    def loss_and_grads():
        tb = _to_torch(block, grad=True)
        xt = torch.tensor(x)
        z, logp = t_cont.flow_block_forward(tb, xt, torch.tensor(c))
        back = t_cont.flow_block_inverse(tb, z, torch.tensor(c),
                                         differentiable=True)
        loss = torch.sum(back ** 2) + torch.sum(logp)
        return [loss, *torch.autograd.grad(loss, jax.tree.leaves(tb))]

    with t_cont.training_solves(*solves):
        inside = loss_and_grads()
    assert calls == {"logp": 1, "solve": 1, "adjoint": 2}
    outside = loss_and_grads()
    assert calls == {"logp": 1, "solve": 1, "adjoint": 2}
    for a, b in zip(inside, outside):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the plain versions of the two kernels
# --------------------------------------------------------------------------
def _net(cdim):
    layers = jax.tree.map(np.asarray, j_cont.odenet_init(KEY, 3, cdim))
    return layers, _to_torch(layers)


@pytest.mark.parametrize("reverse", [False, True])
def test_cnf_solve_logp_plain_matches_jax(reverse):
    """`cnf_solve_logp_plain` against `odeint_dopri5` on JAX's exact-trace
    field and against the interpret-mode `cnf_solve_logp_pallas` as one
    block, both within 5e-6 (`tests/test_cnf.py:370-398`)."""
    layers, tl = _net(32)
    c, y = _rand(1, 2, 100, 32, scale=0.5), _rand(2, 2, 100, 3, scale=0.5)
    logp0 = _rand(3, 2, 100, 1, scale=0.1)
    t0, t1 = (0.47, 0.0) if reverse else (0.0, 0.47)
    ref_y, ref_lp = j_odeint(j_cont.field_with_exact_div(layers, c),
                             (jnp.asarray(y), jnp.asarray(logp0)), t0, t1,
                             1e-5, 1e-5, differentiable=False)
    pal_y, pal_lp = cnf_solve_logp_pallas(layers, c, y, logp0, t0, t1, 1e-5,
                                          1e-5, 128, True)
    (got_y, got_lp), stats = t_cnf.cnf_solve_logp(
        tl, torch.tensor(c), torch.tensor(y), torch.tensor(logp0), t0, t1,
        return_stats=True)
    assert stats["accepted"] <= stats["steps"] < 128
    for got, refs in ((got_y, (ref_y, pal_y)), (got_lp, (ref_lp, pal_lp))):
        for ref in refs:
            assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 5e-6


@pytest.mark.parametrize("with_trace,cdim", [(True, 32), (False, 32),
                                             (False, 128)])
def test_cnf_adjoint_bwd_plain_matches_jax_kernel(with_trace, cdim):
    """`cnf_adjoint_bwd_plain` against the interpret-mode
    `cnf_adjoint_bwd_pallas` (`tests/test_cnf.py:216-336`): y0, a0, dc and
    every parameter gradient within 2e-3 max-relative, the field and its
    trace at t1 within 5e-5 (both are the field at the same point)."""
    layers, tl = _net(cdim)
    c = _rand(1, 1, 60, cdim, scale=0.5)
    y1, a1 = _rand(2, 1, 60, 3, scale=0.5), _rand(3, 1, 60, 3, scale=0.3)
    ap = (_rand(4, 1, 60, 1, scale=0.3) if with_trace
          else np.zeros((1, 60, 1), np.float32))
    ref = cnf_adjoint_bwd_pallas(layers, c, y1, a1, ap, 0.0, 0.47, 1e-5,
                                 1e-5, 128, True, None, with_trace)
    got = t_cnf.cnf_adjoint_bwd(tl, torch.tensor(c), torch.tensor(y1),
                                torch.tensor(a1), torch.tensor(ap), 0.0,
                                0.47, with_trace=with_trace)
    for g, r in zip(got[:3], ref[:3]):
        assert _maxrel(g.numpy(), r) < 2e-3
    assert _tree_maxrel(got[3], ref[3]) < 2e-3
    f1, div1 = got[4][:2]
    assert _maxrel(f1.numpy(), ref[4][0]) < 5e-5
    if with_trace:
        assert _maxrel(div1.numpy(), ref[4][1]) < 5e-5
    else:
        assert float(div1.abs().max()) == 0.0


def test_cnf_adjoint_bwd_plain_unrepeated_conditions():
    """Conditions that serve r = 3 rows each give the summed cotangent of
    the repeated conditions."""
    layers, tl = _net(32)
    c = torch.tensor(_rand(1, 1, 20, 32, scale=0.5))
    y1 = torch.tensor(_rand(2, 1, 60, 3, scale=0.5))
    a1 = torch.tensor(_rand(3, 1, 60, 3, scale=0.3))
    ap = torch.zeros((1, 60, 1))
    got = t_cnf.cnf_adjoint_bwd(tl, c, y1, a1, ap, 0.0, 0.47,
                                with_trace=False)
    ref = t_cnf.cnf_adjoint_bwd(tl, torch.repeat_interleave(c, 3, dim=1), y1,
                                a1, ap, 0.0, 0.47, with_trace=False)
    assert got[2].shape == c.shape
    torch.testing.assert_close(got[2], ref[2].reshape(1, 20, 3, 32).sum(2))
    torch.testing.assert_close(got[0], ref[0])
