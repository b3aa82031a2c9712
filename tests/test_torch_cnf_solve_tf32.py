"""The CNF solve kernels' 3xTF32 arithmetic, checked on the CPU.

`csrc/cnf_solve.cu` evaluates the field (`puflow_cnf_solve`) and the field
with its exact trace (`puflow_cnf_solve_logp`) with the 64 x 64 products
x1 W2 and u1_k W2 on the tensor cores as 3xTF32 (`csrc/cnf_field.cuh:
product`). Here `_field` runs that arithmetic in torch, reading the
weights from the pack the kernel reads (`ops.cnf._field_weights`: the
layers' own weights, then W2 as B fragments): the products split as
`ops/encoder.py:tf32_round` splits, k chunks of 8 in order, each chunk
hi*hi + hi*lo + lo*hi; the gates of layers 1 and 2 once a condition row
(`_gates`), each row reading its condition row's; the rest f32 in the
kernel's order, its fused multiply-adds rounded once (`_fma`): layer 3's
sums and the tangents' diagonal over a lane's 16 columns (8 n + 2 t + e,
in the order n, e) and then a quad's butterfly, -div summed in channel
order.

One evaluation is held to JAX's `field_plain_csl` / `field_with_exact_div`
at 5e-5 max-relative, the field's gate at one point. Then whole solves run
on the emulated field through the port's `models.ode.odeint_dopri5` and
are held to the interpret-mode `cnf_solve_pallas_t` /
`cnf_solve_logp_pallas` at 5e-6 (tests/test_torch_cnf_solve.py's gate for
the seeded net, every step size set by a clip), their step counts to
`cnf_solve_plain`'s / `cnf_solve_logp_plain`'s. The kernels themselves are
held to the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py). Sizes: 1 x 60 rows, as tests/test_torch_adjoint_tf32.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.models.ode import odeint_dopri5 as t_odeint
from puflow_torch.ops import cnf as t_cnf
from puflow_torch.ops.encoder import tf32_round
from puflow_tpu.models import continuous as j_cont
from puflow_tpu.ops.pallas.cnf_pallas import (cnf_solve_logp_pallas,
                                              cnf_solve_pallas_t)
from torch_threads import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
H = 64
ROWS = 60
T1 = 0.47
# the kernel's offsets in the pack (`cnf_field.cuh`)
OWN, FRAG = 4873, 4876
# a lane's columns in the kernel's order: lane t of a quad holds 8 n + 2 t
# + e, n = 0..7, e = 0, 1
LANE_COLS = [[8 * n + 2 * t + e for n in range(8) for e in range(2)]
             for t in range(4)]


def _rand(seed, *shape, scale):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _maxrel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


def _fma(a, b, c):
    """a b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _mm3(a, b):
    """a [M, 64] @ b [64, N] as 3xTF32 products: k chunks of 8 in order,
    each hi*hi + hi*lo + lo*hi accumulated in f32."""
    ah, al = _split(a.contiguous())
    bh, bl = _split(b.contiguous())
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc = acc + ah[:, s] @ bh[s]
        acc = acc + ah[:, s] @ bl[s]
        acc = acc + al[:, s] @ bh[s]
    return acc


def _unfrag(v, k, n):
    """B fragments (`ops/encoder.py:fragment_order`) -> the [k, n]
    matrix."""
    return v.view(k // 8, n // 8, 8, 4, 2).permute(0, 3, 4, 1, 2).reshape(
        k, n)


def _quad_sum(x, w):
    """sum_j x[:, j] w[j] over the 64 columns as the kernel takes it: each
    lane's fused chain over its columns, then the quad's butterfly (xor 1,
    then xor 2): (p0 + p1) + (p2 + p3)."""
    p = []
    for cols in LANE_COLS:
        acc = torch.zeros(x.shape[0], *w.shape[1:])
        for j in cols:
            xj = x[:, j].reshape(-1, *([1] * (w.dim() - 1)))
            acc = _fma(xj, w[j].expand_as(acc), acc)
        p.append(acc)
    return (p[0] + p[1]) + (p[2] + p[3])


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _gate(t, gate_t, gate_c):
    """`cnf_field.cuh:gate`: sigmoid(t gate_t + gate_c), the sum fused."""
    return _sigmoid(_fma(torch.full_like(gate_c, t), gate_t.expand_as(gate_c),
                         gate_c))


class Pack:
    """What the kernel reads of a net, from `ops.cnf._field_weights`."""

    def __init__(self, layers):
        weights, self.wc, self.bc = t_cnf._field_weights(layers)
        own = weights[:OWN]
        self.w1 = own[0:192].view(3, H)
        self.b1, self.gt1, self.bt1 = own[192:384].view(3, H)
        self.w2 = _unfrag(weights[FRAG:FRAG + H * H], H, H)
        self.b2, self.gt2, self.bt2 = own[4480:4672].view(3, H)
        self.w3 = own[4672:4864].view(H, 3)
        self.b3, self.gt3, self.bt3 = own[4864:4873].view(3, 3)
        assert torch.equal(self.w2, layers[1]["layer"]["w"])


def _gates(pk, proj, t):
    """The gates of layers 1 and 2 once a condition row: [conds, 64] each,
    the kernel's gate table."""
    return (_gate(t, pk.gt1, proj[:, 0:64]),
            _gate(t, pk.gt2, proj[:, 128:192]))


def _field(pk, c, rep, t, y, trace):
    """One evaluation in the kernel's arithmetic of rows y [R, 3] with
    conditions c [R / rep, cdim] -> f [R, 3] and, with the trace, -div
    [R, 1]."""
    t = float(t)
    proj = torch.addmm(pk.bc, c, pk.wc)                   # [R / rep, 262]
    s1c, s2c = _gates(pk, proj, t)
    s1, s2 = (s.repeat_interleave(rep, 0) for s in (s1c, s2c))
    pr = proj.repeat_interleave(rep, 0)
    tt = torch.full((y.shape[0], H), t)
    # layer 1
    h1 = _fma(y[:, 2:3], pk.w1[2], _fma(y[:, 1:2], pk.w1[1],
                                        y[:, 0:1] * pk.w1[0])) + pk.b1
    x1 = torch.tanh(_fma(h1, s1, _fma(tt, pk.bt1.expand_as(tt),
                                      pr[:, 64:128])))
    # layer 2 on the tensor cores
    h2 = _mm3(x1, pk.w2) + pk.b2
    x2 = torch.tanh(_fma(h2, s2, _fma(tt, pk.bt2.expand_as(tt),
                                      pr[:, 192:256])))
    # layer 3
    t3 = torch.full((y.shape[0], 3), t)
    s3 = _gate(t, pk.gt3, pr[:, 256:259])
    h3 = _quad_sum(x2, pk.w3)
    f = _fma(h3 + pk.b3, s3, _fma(t3, pk.bt3.expand_as(t3), pr[:, 259:262]))
    if not trace:
        return f, None
    sm1 = s1 * (1 - x1 * x1)
    m2 = 1 - x2 * x2
    d = []
    for k in range(3):
        v2 = _mm3(pk.w1[k] * sm1, pk.w2)
        v3 = _quad_sum(v2 * s2 * m2, pk.w3[:, k])
        d.append(v3 * s3[:, k])
    return f, -((d[0] + d[1]) + d[2])[:, None]


def _case(cdim, rep):
    layers = jax.tree.map(np.asarray, j_cont.odenet_init(KEY, 3, cdim))
    tl = jax.tree.map(lambda v: torch.tensor(np.asarray(v)), layers)
    c = _rand(1, ROWS // rep, cdim, scale=0.5)
    y = _rand(2, ROWS, 3, scale=0.5)
    logp = _rand(5, ROWS, 1, scale=0.1)
    return layers, tl, c, y, logp


CASES = [(32, 1), (128, 4)]


@pytest.mark.parametrize("cdim,rep", CASES)
def test_gates_once_a_condition_row_equal_each_row_s(cdim, rep):
    """The gate table (once a condition row and stage time) repeated over
    the rows equals every row's own gates bit for bit: one formula on the
    same inputs."""
    _, tl, c, _, _ = _case(cdim, rep)
    pk = Pack(tl)
    proj = torch.addmm(pk.bc, torch.tensor(c), pk.wc)
    per_row = proj.repeat_interleave(rep, 0)
    for t in (0.0, 0.1, 0.31, T1):
        for once, each in zip(_gates(pk, proj, t), _gates(pk, per_row, t)):
            assert torch.equal(once.repeat_interleave(rep, 0), each)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cdim,rep", CASES)
def test_solve_field_tf32_matches_jax(trace, cdim, rep):
    """One evaluation in the kernel's arithmetic against JAX's field at
    the same point: 5e-5 max-relative on f and -div."""
    layers, tl, c, y, logp = _case(cdim, rep)
    t = 0.31
    f, neg_div = _field(Pack(tl), torch.tensor(c), rep, t, torch.tensor(y),
                        trace)
    jc = jnp.asarray(np.repeat(c, rep, axis=0))
    if trace:
        ref = j_cont.field_with_exact_div(layers, jc)(
            t, (jnp.asarray(y), jnp.asarray(logp)))
        assert _maxrel(neg_div.numpy(), ref[1]) < 5e-5
        ref = ref[0]
    else:
        ref = j_cont.field_plain_csl(layers, jc)(t, jnp.asarray(y))
    assert _maxrel(f.numpy(), ref) < 5e-5


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cdim,rep", CASES)
def test_solve_tf32_matches_jax_kernel(trace, cdim, rep, reverse):
    """The whole solve on the emulated field against the interpret-mode
    Pallas kernel within 5e-6 (y, and logp with the trace), its step
    counts equal to the plain version's."""
    layers, tl, c, y, logp = _case(cdim, rep)
    pk = Pack(tl)
    ct, yt, lt = torch.tensor(c), torch.tensor(y), torch.tensor(logp)
    t0, t1 = (T1, 0.0) if reverse else (0.0, T1)

    def func(t, state):
        if trace:
            return _field(pk, ct, rep, t, state[0], True)
        return _field(pk, ct, rep, t, state, False)[0]

    state0 = (yt, lt) if trace else yt
    got, stats = t_odeint(func, state0, t0, t1, 1e-5, 1e-5, 128,
                          differentiable=False, return_stats=True)
    jc = np.repeat(c, rep, axis=0)[None]
    if trace:
        _, ref_stats = t_cnf.cnf_solve_logp_plain(
            tl, ct[None], yt[None], lt[None], t0, t1, return_stats=True)
        ref = cnf_solve_logp_pallas(layers, jc, y[None], logp[None], t0, t1,
                                    1e-5, 1e-5, 128, True)
        pairs = [(got[0], ref[0][0]), (got[1], ref[1][0])]
    else:
        _, ref_stats = t_cnf.cnf_solve_plain(tl, ct[None], yt[None], t0, t1,
                                             return_stats=True)
        ref = cnf_solve_pallas_t(layers, jc, y[None], t0, t1, 1e-5, 1e-5,
                                 True)
        pairs = [(got, ref[0])]
    assert [stats["steps"], stats["accepted"]] == [ref_stats["steps"],
                                                   ref_stats["accepted"]]
    for g, r in pairs:
        assert float(np.abs(g.numpy() - np.asarray(r)).max()) < 5e-6
