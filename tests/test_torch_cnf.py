"""The port's CNF family against puflow_tpu on the CPU.

Parameters come from the JAX package (`continuous.init`, `odenet_init`,
`build_model`) as numpy trees and go through `from_numpy_tree` or plain
`torch.tensor`; inputs are numpy-seeded. On CPU tensors `ops.cnf.cnf_solve`
runs its plain version, which is what these tests hold against the JAX
functions; the CUDA kernel is compared with that plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py). The JAX whole-solve kernel runs
in Pallas interpret mode, as tests/test_cnf.py runs it.

Whole-model cases use `discrete.perturb_init`, which gives the CNF layers'
time rows a large scale: a seeded field hardly depends on t and every solve
would take the controller's minimum of three steps. With it the solves
take 4 to 8 steps with some rejected, and at these seeds and shapes both
frameworks take the same accept / reject sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.cli import upsample as t_cli
from puflow_torch.flows import moving_bn as t_mbn
from puflow_torch.inference import patch as t_patch
from puflow_torch.models import continuous as t_cont
from puflow_torch.models import discrete as t_discrete
from puflow_torch.models import fold_bn as t_fold
from puflow_torch.ops import cnf as t_cnf
from puflow_torch.ops.knn import knn_indices as t_knn_indices
from puflow_tpu.checkpoint import _cnf_sample_fn, save_checkpoint
from puflow_tpu.flows import moving_bn as j_mbn
from puflow_tpu.inference import patch as j_patch
from puflow_tpu.models import continuous as j_cont
from puflow_tpu.models import fold_bn as j_fold
from puflow_tpu.models.ode import odeint_dopri5 as j_odeint
from puflow_tpu.ops.pallas.cnf_pallas import cnf_solve_pallas

KEY = jax.random.PRNGKey(0)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _inputs(seed, b, n, cdim):
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, n, cdim) * 0.5).astype(np.float32),
            (rng.randn(b, n, 3) * 0.5).astype(np.float32))


# --------------------------------------------------------------------------
# layer zoo, nonlinearities, fields
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layer_type", sorted(j_cont.DIFFEQ_LAYERS))
def test_zoo_layer_matches_jax(layer_type):
    init_fn, apply_fn = j_cont.DIFFEQ_LAYERS[layer_type]
    p = jax.tree.map(np.array, init_fn(KEY, 5, 7, 4))
    rng = np.random.RandomState(1)
    for leaf in jax.tree.leaves(p):     # move the zero biases
        leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    ctx = rng.randn(2, 6, 5).astype(np.float32)          # [t, c]
    x = rng.randn(2, 6, 5).astype(np.float32)
    ref = np.asarray(apply_fn(p, jnp.asarray(ctx), jnp.asarray(x)))
    got = t_cont.DIFFEQ_LAYERS[layer_type][1](
        _to_torch(p), torch.from_numpy(ctx), torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 6, 7)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the port's own init gives the same tree
    tp = t_cont.DIFFEQ_LAYERS[layer_type][0](
        torch.Generator().manual_seed(0), 5, 7, 4)
    assert (jax.tree.structure(jax.tree.map(np.asarray, tp))
            == jax.tree.structure(p))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, tp)),
                    jax.tree.leaves(p)):
        assert a.shape == b.shape


@pytest.mark.parametrize("name", j_cont.NONLINEARITIES)
def test_odenet_nonlinearity_matches_jax(name):
    layers = jax.tree.map(np.array, j_cont.odenet_init(
        KEY, 3, 6, nonlinearity=name))
    assert isinstance(layers, dict) == (name == "swish")
    if name == "swish":
        layers["swish_beta"] = np.float32(1.3)
    c, y = _inputs(2, 2, 9, 6)
    ref = np.asarray(j_cont.odenet_apply(layers, 0.3, jnp.asarray(c),
                                         jnp.asarray(y), nonlinearity=name))
    got = t_cont.odenet_apply(_to_torch(layers), 0.3, torch.from_numpy(c),
                              torch.from_numpy(y), nonlinearity=name).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    tl = t_cont.odenet_init(torch.Generator().manual_seed(0), 3, 6,
                            nonlinearity=name)
    assert (jax.tree.structure(jax.tree.map(np.asarray, tl))
            == jax.tree.structure(layers))
    with pytest.raises(ValueError, match="unknown nonlinearity"):
        t_cont._apply_nonlinearity("gelu", torch.zeros(1))


@pytest.mark.parametrize("layer_type", ["concatsquash", "concat", "squash"])
def test_odenet_apply_matches_jax(layer_type):
    layers = jax.tree.map(np.array, j_cont.odenet_init(
        KEY, 3, 8, layer_type=layer_type))
    c, y = _inputs(3, 2, 11, 8)
    ref = np.asarray(j_cont.odenet_apply(layers, jnp.asarray(0.7),
                                         jnp.asarray(c), jnp.asarray(y),
                                         layer_type))
    got = t_cont.odenet_apply(_to_torch(layers), torch.tensor(0.7),
                              torch.from_numpy(c), torch.from_numpy(y),
                              layer_type).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.fixture(scope="module")
def net32():
    """JAX-initialised 3-64-64-3 net at cdim 32 with moved biases and time
    rows, and inputs of `tests/test_cnf.py`'s kernel test's shape."""
    layers = jax.tree.map(np.array, j_cont.odenet_init(KEY, 3, 32))
    rng = np.random.RandomState(5)
    for p in layers:
        p["layer"]["b"] += rng.normal(0, 0.1, p["layer"]["b"].shape)
        p["hyper_gate"]["b"] += rng.normal(0, 0.1, p["hyper_gate"]["b"].shape)
        for k in ("hyper_gate", "hyper_bias"):
            p[k]["w"][0] = rng.normal(0, 8.0 if p[k]["w"].shape[1] > 3
                                      else 1.0, p[k]["w"].shape[1])
    c, y = _inputs(4, 2, 100, 32)
    return layers, _to_torch(layers), c, y


def test_field_plain_csl_matches_jax(net32):
    layers, tl, c, y = net32
    ref = np.asarray(j_cont.field_plain_csl(layers, jnp.asarray(c))(
        0.4, jnp.asarray(y)))
    tc, ty = torch.from_numpy(c), torch.from_numpy(y)
    got = t_cont.field_plain_csl(tl, tc)(0.4, ty)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the hoisted field is the net itself
    np.testing.assert_allclose(
        got.numpy(), t_cont.odenet_apply(tl, 0.4, tc, ty).numpy(), atol=1e-5)


def test_fields_with_divergence_match_jax(net32):
    layers, tl, c, y = net32
    c, y = c[:, :7], y[:, :7]
    logp = np.zeros((2, 7, 1), np.float32)
    rdy, rdiv = j_cont.field_with_exact_div(layers, jnp.asarray(c))(
        0.2, (jnp.asarray(y), jnp.asarray(logp)))
    tc, ty = torch.from_numpy(c), torch.from_numpy(y)
    with torch.no_grad():   # forward-mode AD works without grad mode
        gdy, gdiv = t_cont.field_with_exact_div(tl, tc)(
            0.2, (ty, torch.from_numpy(logp)))
    np.testing.assert_allclose(gdy.numpy(), np.asarray(rdy), atol=1e-5)
    np.testing.assert_allclose(gdiv.numpy(), np.asarray(rdiv), atol=1e-5)
    # against a dense Jacobian of the port's own net
    jac = torch.autograd.functional.jacobian(
        lambda v: t_cont.odenet_apply(tl, 0.2, tc[:1, :1], v), ty[:1, :1])
    trace = torch.trace(jac.reshape(3, 3))
    np.testing.assert_allclose(float(-gdiv[0, 0, 0]), float(trace), atol=1e-5)

    e = np.random.RandomState(6).randn(2, 7, 3).astype(np.float32)
    rdy, rdiv = j_cont.field_with_hutchinson_div(
        layers, jnp.asarray(c), jnp.asarray(e))(
            0.2, (jnp.asarray(y), jnp.asarray(logp)))
    gdy, gdiv = t_cont.field_with_hutchinson_div(
        tl, tc, torch.from_numpy(e))(0.2, (ty, torch.from_numpy(logp)))
    np.testing.assert_allclose(gdy.numpy(), np.asarray(rdy), atol=1e-5)
    np.testing.assert_allclose(gdiv.numpy(), np.asarray(rdiv), atol=1e-5)


# --------------------------------------------------------------------------
# the whole-solve function
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("moved", [False, True])
def test_cnf_solve_plain_matches_jax_kernel_and_solver(net32, moved, reverse):
    """5e-6 is tests/test_cnf.py:195-213's bound for the Pallas kernel
    against the XLA solver. On the seeded net of that test (three steps,
    none rejected) the plain version is held to both: measured 4.2e-7
    (kernel) and 1.2e-7 (solver). With the time rows moved the solves take
    4 and 5 attempts, one rejected; there the port is held to JAX's XLA
    solver, same step counts, measured 2.1e-6. The Pallas kernel is not the
    oracle there: its 3-pass bf16 products put about 1e-5 of noise on the
    error estimate, a difference of nearly equal sums, so after a rejected
    step its step sizes, and its result at the solver's tolerance, differ
    from the XLA solver's too (2.0e-5 here)."""
    layers, tl, c, y = net32
    if not moved:
        layers = jax.tree.map(np.array, j_cont.odenet_init(KEY, 3, 32))
        tl = _to_torch(layers)
    T = 0.47
    t0, t1 = (T, 0.0) if reverse else (0.0, T)
    jc, jy = jnp.asarray(c), jnp.asarray(y)
    ref, rst = j_odeint(j_cont.field_plain_csl(layers, jc), jy, t0, t1,
                        1e-5, 1e-5, differentiable=False, return_stats=True)
    tc, ty = torch.from_numpy(c), torch.from_numpy(y)
    got, gst = t_cnf.cnf_solve_plain(tl, tc, ty, t0, t1, return_stats=True)
    assert gst["steps"] == int(rst["steps"])
    assert (gst["steps"] > 3) == moved
    refs = {"solver": ref}
    if not moved:
        refs["kernel"] = cnf_solve_pallas(layers, jc, jy, T, reverse, 1e-5,
                                          1e-5, True)
    for name, r in refs.items():
        err = np.abs(got.numpy() - np.asarray(r)).max()
        print(f"moved={moved} reverse={reverse}: steps {gst}, vs {name} "
              f"{err:.3e}")
        assert err < 5e-6, name
    # on CPU tensors the wrappers run the plain version and count nothing
    before = t_cnf.cnf_solve.launches
    for out in (t_cnf.cnf_solve(tl, tc, ty, T, reverse),
                t_cnf.cnf_solve(tl, tc, ty, torch.tensor(T), reverse),
                t_cnf.cnf_solve_t(tl, tc, ty, t0, t1)):
        assert torch.equal(out, got)
    assert t_cnf.cnf_solve.launches == before


def test_cnf_solve_unrepeated_conditions(net32):
    """A condition row may serve r consecutive rows of y."""
    _, tl, c, y = net32
    tc = torch.from_numpy(c[:, :25])
    ty = torch.from_numpy(y)
    got = t_cnf.cnf_solve(tl, tc, ty, 0.3, True)
    ref = t_cnf.cnf_solve(tl, torch.repeat_interleave(tc, 4, dim=1), ty, 0.3,
                          True)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="do not divide"):
        t_cnf.cnf_solve(tl, tc[:, :7], ty, 0.3)
    with pytest.raises(ValueError, match="condition width"):
        t_cnf.cnf_solve(tl, tc[..., :5], ty[:, :25], 0.3)


def test_kernel_takes_only_the_shipped_field():
    gen = torch.Generator().manual_seed(0)
    assert t_cnf.kernel_takes(t_cont.odenet_init(gen, 3, 32))
    assert t_cnf.kernel_takes(t_cont.odenet_init(gen, 3, 0))
    assert not t_cnf.kernel_takes(t_cont.odenet_init(gen, 3, 32, (64,)))
    assert not t_cnf.kernel_takes(t_cont.odenet_init(gen, 3, 32, (32, 32)))
    assert not t_cnf.kernel_takes(t_cont.odenet_init(gen, 2, 32))
    assert not t_cnf.kernel_takes(
        t_cont.odenet_init(gen, 3, 32, layer_type="squash"))
    assert not t_cnf.kernel_takes(
        t_cont.odenet_init(gen, 3, 32, nonlinearity="swish"))
    layers = t_cont.odenet_init(gen, 3, 8, (32, 32))
    c, y = torch.zeros(1, 4, 8), torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="built for"):
        t_cnf.cnf_solve(layers, c, y, 0.3)


# --------------------------------------------------------------------------
# flow block
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block32(net32):
    layers, tl, c, y = net32
    block = {"sqrt_end_time": np.float32(0.66), "layers": layers}
    return block, _to_torch(block), c[:, :40], y[:, :40]


def test_flow_block_forward_inverse_match_jax(block32):
    block, tb, c, y = block32
    jc, jy = jnp.asarray(c), jnp.asarray(y)
    rz, rlogp = j_cont.flow_block_forward(block, jy, jc, differentiable=False)
    rx = j_cont.flow_block_inverse(block, rz, jc)
    tc, ty = torch.from_numpy(c), torch.from_numpy(y)
    gz, glogp = t_cont.flow_block_forward(tb, ty, tc, differentiable=False)
    gx = t_cont.flow_block_inverse(tb, gz, tc)
    assert gz.shape == (2, 40, 3) and glogp.shape == (2,)
    # measured: z 1.8e-7, x 4.4e-7, the per-cloud log-densities (sums over
    # 40 points) equal
    assert float(glogp.abs().min()) > 1e-3
    np.testing.assert_allclose(gz.numpy(), np.asarray(rz), atol=5e-6)
    np.testing.assert_allclose(glogp.numpy(), np.asarray(rlogp), atol=1e-4)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), atol=5e-6)
    # round trip at the solver's tolerance (tests/test_cnf.py: 5e-4)
    np.testing.assert_allclose(gx.numpy(), y, atol=5e-4)
    # differentiable=True: on CPU tensors the adjoint's forward is the
    # plain log-density solve, the very solve of differentiable=False
    dz, dlogp = t_cont.flow_block_forward(tb, ty, tc)
    assert torch.equal(dz, gz) and torch.equal(dlogp, glogp)


def test_count_nfe_and_total_time_match_jax(block32):
    block, tb, c, y = block32
    params = {"flow_blocks": [block, block]}
    cs = [jnp.asarray(c)] * 2
    ref = int(j_cont.count_nfe(params, jnp.asarray(y), cs))
    got = t_cont.count_nfe({"flow_blocks": [tb, tb]}, torch.from_numpy(y),
                           [torch.from_numpy(c)] * 2)
    assert got == ref
    np.testing.assert_allclose(
        float(t_cont.count_total_time({"flow_blocks": [tb, tb]})),
        float(j_cont.count_total_time(params)), rtol=1e-6)
    np.testing.assert_allclose(
        float(t_cont.count_total_time([("cnf", tb), ("bn", {})])),
        0.66 ** 2, rtol=1e-6)


# --------------------------------------------------------------------------
# moving batch norm and the args-driven chain
# --------------------------------------------------------------------------
def _mbn_case():
    rng = np.random.RandomState(8)
    params = {"weight": rng.normal(0, 0.2, 3).astype(np.float32),
              "bias": rng.normal(0, 0.2, 3).astype(np.float32)}
    state = {"mean": rng.normal(0, 0.3, 3).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 3).astype(np.float32),
             "step": np.array([2.0], np.float32)}
    x = rng.randn(4, 10, 3).astype(np.float32)
    lp = rng.randn(4, 10, 1).astype(np.float32)
    return params, state, x, lp


@pytest.mark.parametrize("train,bn_lag", [(False, 0.0), (True, 0.0),
                                          (True, 0.3)])
def test_moving_bn_forward_matches_jax(train, bn_lag):
    params, state, x, lp = _mbn_case()
    ry, rlp, rs = j_mbn.moving_bn_forward(params, state, jnp.asarray(x),
                                          jnp.asarray(lp), train, bn_lag)
    gy, glp, gs = t_mbn.moving_bn_forward(
        _to_torch(params), _to_torch(state), torch.from_numpy(x),
        torch.from_numpy(lp), train, bn_lag)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), atol=1e-5)
    np.testing.assert_allclose(glp.numpy(), np.asarray(rlp), atol=1e-5)
    for k in ("mean", "var", "step"):
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(rs[k]),
                                   atol=1e-6)
    y_only, none, _ = t_mbn.moving_bn_forward(
        _to_torch(params), _to_torch(state), torch.from_numpy(x), None, train,
        bn_lag)
    assert none is None and torch.equal(y_only, gy)


def test_moving_bn_reverse_matches_jax():
    params, state, x, lp = _mbn_case()
    rx, rlp = j_mbn.moving_bn_reverse(params, state, jnp.asarray(x),
                                      jnp.asarray(lp))
    tp, ts = _to_torch(params), _to_torch(state)
    gx, glp = t_mbn.moving_bn_reverse(tp, ts, torch.from_numpy(x),
                                      torch.from_numpy(lp))
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), atol=1e-5)
    np.testing.assert_allclose(glp.numpy(), np.asarray(rlp), atol=1e-5)
    # eval forward then reverse is the identity on x and on logp
    y, lp2, _ = t_mbn.moving_bn_forward(tp, ts, torch.from_numpy(x),
                                        torch.from_numpy(lp))
    back, lp3 = t_mbn.moving_bn_reverse(tp, ts, y, lp2)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-6)
    np.testing.assert_allclose(lp3.numpy(), lp, atol=1e-6)
    p0, s0 = t_mbn.moving_bn_init(3)
    jp0, js0 = j_mbn.moving_bn_init(3)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, (p0, s0))),
                    jax.tree.leaves(jax.tree.map(np.asarray, (jp0, js0)))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("reverse", [False, True])
def test_sequential_flow_with_batch_norm_matches_jax(reverse):
    cfg = j_cont.CNFChainConfig(batch_norm=True, time_length=0.3)
    chain, chain_state = j_cont.build_model(KEY, 3, (64, 64), 8, 2, True, cfg)
    assert [k for k, _ in chain] == ["bn", "cnf", "bn", "cnf", "bn"]
    rng = np.random.RandomState(9)
    chain = [(k, jax.tree.map(np.array, p)) for k, p in chain]
    chain_state = [None if s is None else jax.tree.map(np.array, s)
                   for s in chain_state]
    for (kind, p), s in zip(chain, chain_state):
        if kind == "bn":
            p["weight"] += rng.normal(0, 0.2, 3)
            p["bias"] += rng.normal(0, 0.2, 3)
            s["mean"] += rng.normal(0, 0.2, 3)
            s["var"] *= rng.uniform(0.6, 1.4, 3)
    c, x = _inputs(10, 2, 12, 8)
    rx, rlp, _ = j_cont.sequential_flow_apply(
        chain, chain_state, jnp.asarray(x), jnp.asarray(c), reverse=reverse,
        cfg=cfg)
    t_chain = [(k, _to_torch(p)) for k, p in chain]
    t_state = [None if s is None else _to_torch(s) for s in chain_state]
    t_cfg = t_cont.CNFChainConfig(batch_norm=True, time_length=0.3)
    gx, glp, gs = t_cont.sequential_flow_apply(
        t_chain, t_state, torch.from_numpy(x), torch.from_numpy(c),
        reverse=reverse, cfg=t_cfg)
    # measured: x 4.8e-7, logp 6.0e-8
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), atol=1e-5)
    np.testing.assert_allclose(glp.numpy(), np.asarray(rlp), atol=1e-4)
    assert len(gs) == len(chain)
    # the port builds the same chain, and trains through it: gradients
    # reach every CNF block's end time
    b_chain, b_state = t_cont.build_model(
        torch.Generator().manual_seed(0), 3, (64, 64), 8, 2, True, t_cfg,
        device="cpu")
    assert [k for k, _ in b_chain] == [k for k, _ in chain]
    assert [s is None for s in b_state] == [s is None for s in chain_state]
    ends = [p["sqrt_end_time"].requires_grad_()
            for k, p in b_chain if k == "cnf"]
    tx, tlp, _ = t_cont.sequential_flow_apply(
        b_chain, b_state, torch.from_numpy(x), torch.from_numpy(c),
        reverse=reverse, train=True, cfg=t_cfg)
    grads = torch.autograd.grad(torch.sum(tx ** 2) + torch.sum(tlp), ends)
    assert all(bool(torch.isfinite(g)) and float(g) != 0.0 for g in grads)
    # an unconditional chain takes no condition
    u_chain, u_state = t_cont.build_model(
        torch.Generator().manual_seed(0), 3, (64, 64), 8, 1, False,
        device="cpu")
    ux, ulp, _ = t_cont.sequential_flow_apply(u_chain, u_state,
                                              torch.from_numpy(x))
    assert ux.shape == (2, 12, 3) and ulp.shape == (2, 12, 1)


# --------------------------------------------------------------------------
# whole model
# --------------------------------------------------------------------------
B, N, R = 2, 64, 4


@pytest.fixture(scope="module")
def case():
    params, state = j_cont.init(KEY)
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 7)
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    model = t_checkpoint.from_numpy_tree(params, state, "cpu", model="cnf")
    tp, ts = model.trees()
    x = (np.random.RandomState(7).randn(B, N, 3) * 0.3).astype(np.float32)
    return dict(params=params, state=state, jp=jp, js=js, model=model,
                jf=j_fold.fold_bn_inference(jp, js),
                tf=t_fold.fold_bn_inference(tp, ts), tp=tp, ts=ts, x=x,
                xt=torch.from_numpy(x))


def test_init_and_checkpoint_trees_match_jax(case, tmp_path):
    tp, ts = t_cont.init(torch.Generator().manual_seed(0), device="cpu")
    got = jax.tree.map(np.asarray, (tp, ts))
    ref = (case["params"], case["state"])
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert isinstance(case["model"], t_cont.ContinuousModel)
    assert "params.flow_blocks.0.sqrt_end_time" in case["model"].state_dict()
    # numpy trees -> model -> numpy trees -> .npz -> model, unchanged
    back = t_checkpoint.to_numpy_tree(case["model"])
    path = str(tmp_path / "cnf.npz")
    t_checkpoint.save_checkpoint(path, *back)
    loaded = t_checkpoint.load_checkpoint(path, "cpu", model="cnf")
    assert isinstance(loaded, t_cont.ContinuousModel)
    for a, b, c in zip(jax.tree.leaves(back), jax.tree.leaves(ref),
                       jax.tree.leaves(t_checkpoint.to_numpy_tree(loaded))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    folded = t_checkpoint.load_checkpoint(path, "cpu", fold=True, model="cnf")
    assert isinstance(folded, t_cont.ContinuousModel)
    assert t_discrete.is_folded(folded.trees()[0])
    with pytest.raises(ValueError, match="unknown model family"):
        t_checkpoint.load_checkpoint(path, "cpu", model="glow")


@pytest.mark.parametrize("folded", [False, True])
def test_sample_matches_jax(case, folded):
    """Whole `continuous.sample`, 12 block-solves: atol 1e-4, the bound of
    the discrete `sample` (tests/test_torch_model.py). Measured 8.0e-6
    unfolded and 7.7e-6 folded."""
    jp = case["jf"] if folded else case["jp"]
    ref = np.asarray(j_cont.sample(jp, case["js"], jnp.asarray(case["x"]), R))
    if folded:
        got = t_cont.sample(case["tf"], None, case["xt"], R).numpy()
        via_module = t_cont.ContinuousModel(
            case["tf"], t_fold.empty_bn_state(case["ts"]))(case["xt"], R)
    else:
        got = t_cont.sample(case["tp"], case["ts"], case["xt"], R).numpy()
        via_module = case["model"](case["xt"], R)
    assert got.shape == (B, N * R, 3) and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    print(f"continuous.sample folded={folded}: max_abs_err {err:.3e}")
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(via_module.numpy(), got)


@pytest.mark.parametrize("folded", [False, True])
def test_forward_eval_matches_jax(case, folded):
    """`forward(train=False)`: the dense cloud and the NLL through the
    exact-trace field. atol 1e-4 on the cloud; the NLL is a mean of
    log-densities of size 1e2 summed over 64 points: rtol 1e-5 (measured
    equal to the six digits printed; the cloud 7.9e-6)."""
    jp = case["jf"] if folded else case["jp"]
    rx, rnll, _ = j_cont.forward(jp, case["js"], jnp.asarray(case["x"]), R,
                                 train=False)
    tp = case["tf"] if folded else case["tp"]
    with torch.no_grad():
        gx, gnll, new_state = t_cont.forward(tp, case["ts"], case["xt"], R)
    assert gx.shape == (B, N * R, 3)
    err = np.abs(gx.numpy() - np.asarray(rx)).max()
    print(f"continuous.forward folded={folded}: max_abs_err {err:.3e}, nll "
          f"{float(gnll):.6f} vs {float(rnll):.6f}")
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), atol=1e-4)
    np.testing.assert_allclose(float(gnll), float(rnll), rtol=1e-5)
    assert set(new_state) == {"interp", "feat_convs"}
    # train=True (BN on batch statistics, differentiable solves) runs on
    # the CPU; the unfolded trees, since training keeps BN
    with torch.no_grad():
        tx, tnll, t_state = t_cont.forward(case["tp"], case["ts"], case["xt"],
                                           R, train=True)
    assert tx.shape == (B, N * R, 3) and bool(torch.isfinite(tx).all())
    assert bool(torch.isfinite(tnll)) and set(t_state) == set(new_state)


def test_f_g_transform_match_jax(case):
    x, jx = case["xt"], jnp.asarray(case["x"])
    idx = t_knn_indices(x, x, 16)
    cs, _ = t_discrete.feat_extract(case["tp"], case["ts"], x, idx)
    jcs = [jnp.asarray(c.numpy()) for c in cs]
    rz, _ = j_cont.f_transform(case["jp"], jx, jcs, differentiable=False,
                               need_logp=False)
    gz, gld = t_cont.f_transform(case["tp"], x, cs, differentiable=False,
                                 need_logp=False)
    np.testing.assert_allclose(gz.numpy(), np.asarray(rz), atol=1e-5)
    assert float(gld.abs().max()) == 0.0
    fz = np.random.RandomState(11).randn(B, N, 3, R).astype(np.float32) * 0.5
    rg = j_cont.g_transform(case["jp"], jnp.asarray(fz), jcs, R)
    gg = t_cont.g_transform(case["tp"], torch.from_numpy(fz), cs, R)
    assert gg.shape == (B, N * R, 3)
    np.testing.assert_allclose(gg.numpy(), np.asarray(rg), atol=1e-5)
    with pytest.raises(ValueError, match="samples"):
        t_cont.g_transform(case["tp"], torch.from_numpy(fz), cs, 2)


def _chamfer(a, b):
    d = ((a[0][:, None, :] - b[0][None, :, :]) ** 2).sum(-1)
    return d.min(1).mean() + d.min(0).mean()


def test_cnf_pipeline_matches_jax():
    """`upsample_cloud` + `remove_outliers` on the 512-point test cloud of
    tests/test_torch_pipeline.py through the CNF model, BN folded (the
    CLI's default): Chamfer to the JAX pipeline below 1.5e-3, the repo's
    pipeline gate (tests/test_pipeline_parity.py:177-199); measured
    7.1e-12."""
    n, patch, outliers = 512, 64, 24
    npoint = n * R + outliers
    params, state = j_cont.init(KEY)
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 3)
    rng = np.random.RandomState(0)
    pts = rng.randn(1, n, 3).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)

    jp, js = jax.tree.map(jnp.asarray, (params, state))
    cloud = jnp.asarray(pts)
    ref = j_patch.upsample_cloud((j_fold.fold_bn_inference(jp, js), js),
                                 cloud, _cnf_sample_fn, npoint, R, patch,
                                 4.0, None, False, 0)
    ref = np.asarray(j_patch.remove_outliers(ref, cloud, outliers))

    model = t_checkpoint.from_numpy_tree(params, state, "cpu", model="cnf")
    tp, ts = model.trees()
    folded = t_cont.ContinuousModel(t_fold.fold_bn_inference(tp, ts),
                                    t_fold.empty_bn_state(ts))
    pc = torch.from_numpy(pts)
    got = t_patch.upsample_cloud(folded, pc, npoint, R, patch, 4.0)
    got = t_patch.remove_outliers(got, pc, outliers).numpy()
    assert got.shape == ref.shape == (1, n * R, 3)
    assert np.isfinite(got).all()
    cd = _chamfer(got, ref)
    print(f"CNF pipeline vs JAX: CD {cd:.3e}")
    assert cd < 1.5e-3


@pytest.mark.parametrize("exact", [False, True])
def test_cli_upsamples_with_the_cnf_model(tmp_path, monkeypatch, exact):
    params, state = j_cont.init(KEY)
    ckpt = str(tmp_path / "cnf.npz")
    save_checkpoint(ckpt, params, state)
    src = tmp_path / "in"
    src.mkdir()
    pts = np.random.RandomState(0).randn(128, 3)
    np.savetxt(src / "cloud.xyz", pts, fmt="%.6f")

    loaded = []
    load = t_checkpoint.load_checkpoint

    def spy(*args, **kwargs):
        loaded.append(load(*args, **kwargs))
        return loaded[-1]

    monkeypatch.setattr(t_checkpoint, "load_checkpoint", spy)
    t_cli.main(["--source", str(src), "--target", str(tmp_path / "out"),
                "--checkpoint", ckpt, "--num_patch", "32", "--model", "cnf",
                "--device", "cpu"] + (["--exact"] if exact else []))
    assert isinstance(loaded[0], t_cont.ContinuousModel)
    assert t_discrete.is_folded(loaded[0].trees()[0]) != exact
    lines = (tmp_path / "out" / "cloud.xyz").read_text().splitlines()
    assert len(lines) == 128 * R
    assert np.isfinite(np.loadtxt(tmp_path / "out" / "cloud.xyz")).all()
