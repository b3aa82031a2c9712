"""puflow_torch spline flows and spline coupling against puflow_tpu.

The same numpy inputs and raw parameters go to both packages. Gates:

* values: atol 2e-5 on outputs, 5e-4 on log-dets, forward and inverse,
  all three kinds, at JAX's test setting (8 bins, tail bound 3) and the
  coupling's (64 bins, tail bound 5), inputs on bin edges, on the tail
  bounds and outside the tails included. The port runs in float32; the
  reference is the JAX function evaluated in float64 (the two packages
  agree to 1e-12 in float64, `test_spline_float64_is_the_jax_function`).
  JAX's own float32 misses these gates (4.2e-4 on cubic inverse lanes
  where Cardano's second cube root cancels; 3.2e-5 on a 64-bin
  linear-rational forward lane), so its float32 values cannot be the
  reference. A float32 bin edge near the tail bound is rounded by up to an
  ulp of the bound, and next to the knots of narrow bins the log-det's
  slope passes 1,000 (JAX's float32 log-dets are up to 2.1e-3 from its
  float64 there): a lane's log-det gate is 5e-4 plus its slope times two
  float32 ulps of the tail bound (at most 1.4e-4 on this data);
* JAX's own property tests (`tests/test_spline.py`) at their tolerances;
* gradients of ``sum(out) + sum(logdet)`` with respect to the inputs and
  the raw parameters: rtol 1e-3, atol 1e-4 (`tests/test_spline.py:95`),
  against `jax.grad`; every gradient finite, outside the tails too. JAX's
  cubic inverse has NaN gradients (``0 * inf`` through its clipped square
  roots), so there the reference is central differences of the JAX
  function in float64. At 64 bins float32 gradients of either package
  are up to 4.7 times the gate from their float64 values, so that setting
  is compared in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.checkpoint import _map_tree
from puflow_torch.flows import spline as t_spline
from puflow_torch.flows import spline_coupling as t_sc
from puflow_tpu.flows import spline as j_spline
from puflow_tpu.flows import spline_coupling as j_sc
from puflow_tpu.flows.coupling import linear_a1d_apply as j_linear_a1d_apply
from torch_spline_cases import coupling_case
from torch_threads import one_torch_thread  # noqa: F401

OUT_ATOL, LD_ATOL = 2e-5, 5e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
SETTINGS = {"8bins": (8, 3.0), "64bins": (64, 5.0)}
KINDS = ("quadratic", "linear-rational", "cubic")
# raw parameters of each kind, in call order: (name, extra width)
PARAMS = {"quadratic": (("uw", 0), ("uh", 0), ("ud", -1)),
          "linear-rational": (("uw", 0), ("uh", 0), ("ud", -1), ("ul", 0)),
          "cubic": (("uw", 0), ("uh", 0), ("dl", None), ("dr", None))}
FUNCS = {"quadratic": "rational_quadratic_spline",
         "linear-rational": "rational_linear_spline",
         "cubic": "cubic_spline"}


def _raw(rng, shape, kind, nb):
    """Raw parameters as JAX's test draws them: N(0, 1) * 0.5."""
    return [(rng.randn(*shape, 1 if extra is None else nb + extra) * 0.5
             ).astype(np.float32) for _, extra in PARAMS[kind]]


def _call(pkg, kind, x, raw, inverse, nb, tb):
    fn = getattr(pkg, FUNCS[kind])
    return fn(x, *raw, inverse, num_bins=nb, tail_bound=tb)


def _jax(kind, x, raw, inverse, nb, tb, dtype=jnp.float32):
    with jax.enable_x64(dtype == jnp.float64):
        out, ld = _call(j_spline, kind, jnp.asarray(x, dtype),
                        [jnp.asarray(r, dtype) for r in raw], inverse, nb, tb)
        return np.asarray(out), np.asarray(ld)


def _torch(kind, x, raw, inverse, nb, tb, dtype=torch.float32):
    out, ld = _call(t_spline, kind, torch.from_numpy(x).to(dtype),
                    [torch.from_numpy(r).to(dtype) for r in raw], inverse,
                    nb, tb)
    return out.numpy(), ld.numpy()


def _edges(kind, raw, inverse, nb, tb):
    """Each lane's bin edges in the input's domain, as JAX computes them
    (float32): cumulative widths forward, heights inverse."""
    u = jnp.asarray(raw[1] if inverse else raw[0])
    if kind == "cubic":
        w = jax.nn.softmax(u, axis=-1)
        w = 1e-3 + (1 - 1e-3 * nb) * w
        cum = jnp.pad(jnp.cumsum(w, axis=-1)[..., :-1],
                      [(0, 0)] * (w.ndim - 1) + [(1, 0)])
        return np.asarray(cum * 2 * tb - tb)
    cum, _ = j_spline._normalise_bins(u, nb, 1e-3, -tb, tb)
    return np.asarray(cum[..., :-1])


def _case(seed, kind, inverse, nb, tb, shape=(8, 256, 2)):
    """Inputs from N(0, 2), a block of lanes moved onto their own bin
    edges, and lanes on and outside the tail bounds."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    raw = _raw(rng, shape, kind, nb)
    edges = _edges(kind, raw, inverse, nb, tb)
    pick = rng.randint(0, nb, shape)
    on_edge = np.take_along_axis(edges, pick[..., None], -1)[..., 0]
    x[1] = on_edge[1]
    x[0, :4, 0] = [-tb, tb, -tb - 1e-3, tb + 1e-3]
    x[0, :4, 1] = [-3 * tb, 2 * tb, -tb - 7, tb + 100]
    return x, raw


CASES = [(s, k, inv) for s in SETTINGS for k in KINDS for inv in (False, True)]


def _logdet_slope(kind, x, raw, inverse, nb, tb, h=1e-7):
    """|d logdet / dx| of each lane, central differences of the JAX
    function in float64; 0 within 2h of the tails (the log-det jumps
    there)."""
    with jax.enable_x64(True):
        fn = jax.jit(lambda v, *r: _call(j_spline, kind, v, r, inverse, nb,
                                         tb)[1])
        r64 = [jnp.asarray(r, jnp.float64) for r in raw]
        x64 = np.asarray(x, np.float64)
        slope = np.abs(np.asarray(fn(x64 + h, *r64))
                       - np.asarray(fn(x64 - h, *r64))) / (2 * h)
    return np.where(np.abs(x64) < tb - 2 * h, slope, 0.0)


@pytest.mark.parametrize("setting,kind,inverse", CASES)
def test_spline_float32_matches_jax(setting, kind, inverse):
    nb, tb = SETTINGS[setting]
    x, raw = _case(0, kind, inverse, nb, tb)
    out, ld = _torch(kind, x, raw, inverse, nb, tb)
    ref_out, ref_ld = _jax(kind, x, raw, inverse, nb, tb, jnp.float64)
    assert np.isfinite(out).all() and np.isfinite(ld).all()
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=OUT_ATOL)
    edge_ulp = 2.0 ** (np.floor(np.log2(tb)) - 23)
    gate = LD_ATOL + 2 * edge_ulp * _logdet_slope(kind, x, raw, inverse, nb,
                                                  tb)
    bad = np.abs(ld - ref_ld) > gate
    assert not bad.any(), (np.abs(ld - ref_ld)[bad], gate[bad])
    # the tails are the identity, bit for bit
    tail = np.abs(x) > tb
    assert tail[0, :4].sum() == 6
    np.testing.assert_array_equal(out[tail], x[tail])
    np.testing.assert_array_equal(ld[tail], 0.0)


@pytest.mark.parametrize("setting,kind,inverse", CASES)
def test_spline_float64_is_the_jax_function(setting, kind, inverse):
    """Both packages in float64: the same function to rounding."""
    nb, tb = SETTINGS[setting]
    x, raw = _case(1, kind, inverse, nb, tb)
    out, ld = _torch(kind, x, raw, inverse, nb, tb, torch.float64)
    ref_out, ref_ld = _jax(kind, x, raw, inverse, nb, tb, jnp.float64)
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ld, ref_ld, rtol=0, atol=1e-9)


@pytest.mark.parametrize("inverse", [False, True])
def test_bin_search_counts_edges_as_jax(inverse):
    """`_searchsorted` is the count of edges at or below the input (the
    last edge raised by eps), on inputs exactly on the edges too."""
    rng = np.random.RandomState(2)
    nb = 8
    cum, _ = j_spline._normalise_bins(jnp.asarray(rng.randn(64, nb)), nb,
                                      1e-3, -3.0, 3.0)
    cum = np.array(cum, np.float32)
    x = np.concatenate([cum, cum + 1e-7, cum - 1e-7,
                        rng.uniform(-4, 4, (64, 9)).astype(np.float32)], -1)
    got = t_spline._searchsorted(torch.from_numpy(cum)[:, None, :],
                                 torch.from_numpy(x))
    want = j_spline._searchsorted(jnp.asarray(cum)[:, None, :],
                                  jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------------
# JAX's own property tests (tests/test_spline.py), on the port
# ------------------------------------------------------------------------
NB, TB = 8, 3.0


def _apply(kind, x, inverse, seed=0):
    rng = np.random.RandomState(seed)
    raw = [torch.from_numpy(r) for r in _raw(rng, tuple(x.shape), kind, NB)]
    return _call(t_spline, kind, x, raw, inverse, NB, TB)


@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip(kind):
    x = torch.linspace(-2.9, 2.9, 64).reshape(4, 16)
    y, ld_f = _apply(kind, x, False)
    x2, ld_i = _apply(kind, y, True)
    atol = 2e-2 if kind == "cubic" else 1e-4
    np.testing.assert_allclose(x2.numpy(), x.numpy(), atol=atol)
    np.testing.assert_allclose((ld_f + ld_i).numpy(), 0.0, atol=atol)


@pytest.mark.parametrize("kind", KINDS)
def test_monotone(kind):
    """One shared parameter set over a dense grid: strictly increasing."""
    n = 512
    x = torch.linspace(-2.99, 2.99, n).reshape(1, n)
    rng = np.random.RandomState(7)
    raw = [torch.from_numpy(r).expand(1, n, r.shape[-1])
           for r in _raw(rng, (1, 1), kind, NB)]
    y, _ = _call(t_spline, kind, x, raw, False, NB, TB)
    assert (np.diff(y.numpy()[0]) > 0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_logdet_vs_jacobian(kind):
    x = torch.tensor([[0.3, -1.2, 2.1, -0.05]])
    _, ld = _apply(kind, x, False)
    jac = torch.autograd.functional.jacobian(
        lambda v: _apply(kind, v, False)[0].reshape(-1), x).reshape(4, 4)
    want = np.log(np.abs(np.diagonal(jac.numpy())))
    np.testing.assert_allclose(ld.numpy().ravel(), want, rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_identity_tails(kind):
    x = torch.tensor([[-10.0, 4.5, 100.0]])
    y, ld = _apply(kind, x, False)
    np.testing.assert_array_equal(y.numpy(), x.numpy())
    np.testing.assert_array_equal(ld.numpy(), 0.0)


# ------------------------------------------------------------------------
# gradients
# ------------------------------------------------------------------------
def _grad_case(seed, kind, nb, tb):
    """Inputs from N(0, 2) (off the bin edges, where the log-det has a
    kink) with lanes outside both tails."""
    rng = np.random.RandomState(seed)
    shape = (2, 64, 2)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    x[0, :3, 0] = [-tb - 1, tb + 2, -5 * tb]
    return x, _raw(rng, shape, kind, nb)


def _torch_grads(kind, x, raw, inverse, nb, tb, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in [x] + raw]
    out, ld = _call(t_spline, kind, leaves[0], leaves[1:], inverse, nb, tb)
    return [g.numpy() for g in torch.autograd.grad(out.sum() + ld.sum(),
                                                   leaves)]


def _jax_grads(kind, x, raw, inverse, nb, tb, dtype):
    def loss(*args):
        out, ld = _call(j_spline, kind, args[0], args[1:], inverse, nb, tb)
        return out.sum() + ld.sum()

    with jax.enable_x64(dtype == jnp.float64):
        args = [jnp.asarray(a, dtype) for a in [x] + raw]
        grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
        return [np.asarray(g) for g in grads]


def _jax_central_differences(kind, x, raw, inverse, nb, tb, h=1e-6):
    """d(out + logdet) of each lane by float64 central differences of the
    JAX function: a lane's output depends only on its own input and
    parameters, so one pair of calls gives every lane's derivative in one
    coordinate."""
    with jax.enable_x64(True):
        fn = jax.jit(lambda *a: sum(_call(j_spline, kind, a[0], a[1:],
                                          inverse, nb, tb)))
        args = [np.asarray(a, np.float64) for a in [x] + raw]
        grads = []
        for i, a in enumerate(args):
            g = np.zeros_like(a)
            for k in ([None] if i == 0 else range(a.shape[-1])):
                step = np.zeros_like(a)
                if k is None:
                    step[...] = h
                else:
                    step[..., k] = h
                plus = [b + step if j == i else b for j, b in enumerate(args)]
                minus = [b - step if j == i else b for j, b in enumerate(args)]
                d = (np.asarray(fn(*plus)) - np.asarray(fn(*minus))) / (2 * h)
                if k is None:
                    g[...] = d
                else:
                    g[..., k] = d
            grads.append(g)
        return grads


@pytest.mark.parametrize("setting,kind,inverse", CASES)
def test_spline_gradients_match_jax(setting, kind, inverse):
    nb, tb = SETTINGS[setting]
    x, raw = _grad_case(3, kind, nb, tb)
    # float32 at JAX's test setting, float64 at 64 bins (module docstring)
    tdt, jdt = ((torch.float32, jnp.float32) if setting == "8bins"
                else (torch.float64, jnp.float64))
    got = _torch_grads(kind, x, raw, inverse, nb, tb, tdt)
    if kind == "cubic" and inverse:
        # JAX's gradients are NaN here: its float64 central differences
        assert not all(np.isfinite(g).all() for g in
                       _jax_grads(kind, x, raw, inverse, nb, tb, jdt))
        want = _jax_central_differences(kind, x, raw, inverse, nb, tb)
    else:
        want = _jax_grads(kind, x, raw, inverse, nb, tb, jdt)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # outside the tails: the identity, d/dx 1, no parameter gradient
    np.testing.assert_array_equal(got[0][0, :3, 0], 1.0)
    for g in got[1:]:
        np.testing.assert_array_equal(g[0, :3, 0], 0.0)


# ------------------------------------------------------------------------
# spline coupling
# ------------------------------------------------------------------------
B, N, C, CDIM, H = 2, 17, 3, 8, 16


def _coupling_case(seed, kind, split):
    """A transform net with every layer non-zero (seeded init zeroes the
    head, which would make the coupling the identity)."""
    rng = np.random.RandomState(seed)
    mult = t_sc.param_multiplier(kind)
    c_in = split + CDIM
    net = {"w0": (rng.randn(c_in, H) / np.sqrt(c_in)).astype(np.float32),
           "w1": (rng.randn(H, H) / np.sqrt(H)).astype(np.float32),
           "b1": (rng.randn(H) * 0.1).astype(np.float32),
           "w2": (rng.randn(H, (C - split) * mult) * 0.3).astype(np.float32),
           "b2": (rng.randn((C - split) * mult) * 0.1).astype(np.float32)}
    x = (rng.randn(B, N, C) * 2).astype(np.float32)
    x[0, 0] = [6.0, -7.0, 5.5]                     # outside the tails
    c = rng.randn(B, N, CDIM).astype(np.float32)
    return {"transform_net": net}, x, c


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("split", [1, 2])
def test_spline_coupling_matches_jax_and_inverts(kind, split):
    """The discrete flow's splits (1 and 2 of 3 channels), the port in
    float32 against JAX's coupling with float64 enabled (its transform
    net still rounds to float32 at its output, as the port's does), at
    the spline gates; the round trip at JAX's gates."""
    params, x, c = _coupling_case(10 + split, kind, split)
    tp = _map_tree(torch.from_numpy, params)
    z, ld = t_sc.spline_coupling_forward(tp, torch.from_numpy(x),
                                         torch.from_numpy(c), split, kind)
    with jax.enable_x64(True):
        jp = _map_tree(jnp.asarray, params)
        zj, ldj = j_sc.spline_coupling_forward(
            jp, jnp.asarray(x, jnp.float64), jnp.asarray(c), split, kind)
        xj, ldij = j_sc.spline_coupling_inverse(
            jp, jnp.asarray(z.numpy(), jnp.float64), jnp.asarray(c), split,
            kind)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), atol=OUT_ATOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), atol=LD_ATOL)
    assert np.abs(z.numpy() - x).max() > 0.1       # the net moves h2
    x2, ld_i = t_sc.spline_coupling_inverse(tp, z, torch.from_numpy(c),
                                            split, kind)
    np.testing.assert_allclose(x2.numpy(), np.asarray(xj), atol=OUT_ATOL)
    np.testing.assert_allclose(ld_i.numpy(), np.asarray(ldij), atol=LD_ATOL)
    atol = 2e-2 if kind == "cubic" else 1e-4
    np.testing.assert_allclose(x2.numpy(), x, atol=atol)
    np.testing.assert_allclose((ld + ld_i).numpy(), 0.0, atol=atol)


def test_spline_coupling_init_matches_jax():
    """`spline_coupling_init` builds JAX's tree (keys and shapes) with a
    zero head, so the raw parameters are 0 whatever the random layers
    hold, and both packages' fresh couplings are the same map."""
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 11, 4) * 2).astype(np.float32)
    c = rng.randn(3, 11, 5).astype(np.float32)
    for kind in KINDS:
        tp = t_sc.spline_coupling_init(torch.Generator().manual_seed(0), 2,
                                       16, 2, 5, kind, device="cpu")
        jp = j_sc.spline_coupling_init(jax.random.PRNGKey(0), 2, 16, 2, 5,
                                       kind)
        assert (_map_tree(lambda t: tuple(t.shape), tp)
                == _map_tree(lambda a: tuple(a.shape), jp))
        assert not tp["transform_net"]["w2"].any()
        z, ld = t_sc.spline_coupling_forward(tp, torch.from_numpy(x),
                                             torch.from_numpy(c), 2, kind)
        with jax.enable_x64(True):
            zj, ldj = j_sc.spline_coupling_forward(
                jp, jnp.asarray(x, jnp.float64), jnp.asarray(c), 2, kind)
        np.testing.assert_allclose(z.numpy(), np.asarray(zj), atol=OUT_ATOL)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ldj),
                                   atol=LD_ATOL)


def test_spline_coupling_init_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_sc.spline_coupling_init(torch.Generator(), 2, 16, 2, 5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("split", [1, 2])
def test_spline_coupling_at_the_flow_widths_matches_jax(kind, split):
    """The case `chip_smoke.py:phase_library` and the card tests run (3
    channels, hidden 64, conditions of 128, 64 bins, tail bound 5; 2
    patches of 256 points here), the port's float32 lanes against JAX's
    with float64 enabled, forward and inverse, at the value gates."""
    params, x, c = coupling_case(split, kind, split, 2, 256, "cpu")
    net = {k: v.numpy() for k, v in params["transform_net"].items()}
    z = t_sc.spline_coupling_forward(params, x, c, split, kind)[0]
    for inverse, inp in ((False, x), (True, z)):
        h1, h2 = inp[..., :split], inp[..., split:]
        raw = t_sc.linear_a1d_apply(params["transform_net"], h1, c)
        out, ld = t_sc._piecewise(h2, raw.reshape(h2.shape + (-1,)), kind,
                                  inverse, 64)
        with jax.enable_x64(True):
            raw_j = j_linear_a1d_apply(_map_tree(jnp.asarray, net),
                                     jnp.asarray(h1.numpy()),
                                     jnp.asarray(c.numpy()))
            raw_j = raw_j.reshape(h2.shape + (-1,))

            def lane(v, raw_j=raw_j, inverse=inverse):
                return j_sc._piecewise(v, raw_j, kind, inverse, 64)

            h2_64 = jnp.asarray(h2.numpy(), jnp.float64)
            out_j, ld_j = map(np.asarray, lane(h2_64))
            step = 1e-7
            slope = np.abs(np.asarray(lane(h2_64 + step)[1])
                           - np.asarray(lane(h2_64 - step)[1])) / (2 * step)
        slope = np.where(np.abs(h2.numpy()) < t_sc.TAIL_BOUND - 2 * step,
                         slope, 0.0)
        assert np.isfinite(out.numpy()).all() and np.isfinite(ld.numpy()).all()
        np.testing.assert_allclose(out.numpy(), out_j, rtol=0, atol=OUT_ATOL)
        gate = LD_ATOL + 2 * 2.0 ** -21 * slope       # 2 ulps of 5 (f32)
        assert (np.abs(ld.numpy() - ld_j) <= gate).all()
