"""The CNF adjoint kernel's 3xTF32 arithmetic, checked on the CPU.

`csrc/cnf_adjoint.cu` evaluates the augmented field of the continuous
adjoint with every product of 64-wide operands on the tensor cores as
3xTF32 (`csrc/mma_tf32.cuh`). Here `_aug_field` runs that arithmetic in
torch, reading the weights from the pack the kernel reads
(`ops.cnf._adjoint_pack`: W2 and W2^T as B fragments, the projection
matrix transposed as B fragments): x1 W2, u1_k W2, dh2 W2^T, cv2_k W2^T,
W2's gradient over each tile of rows (16 with the trace, 32 without) and
the condition cotangents Wc q and
c^T Q as products split as `ops/encoder.py:tf32_round` splits, k chunks of
8 in order, each chunk hi*hi + hi*lo + lo*hi; the 3 -> 64 and 64 -> 3
layers, the epilogues and the other gradient sums in f32, the column sums
over a tile's rows in the kernel's order (rows rg, rg + 4, rg + 8, ... of
each row group rg, then the groups in order, then the tiles; layer 3's
vectors by rows 16 apart, then a butterfly over 16 lanes), the repeats of
a condition row summed in row order before c^T Q.

One evaluation is held to JAX's augmented field (`jax.vjp` of the field,
as `make_adjoint_odeint` forms it) on the same inputs at 5e-5
max-relative, the gate of the field at one point: f, -dS/dy, -div, every
leaf of dS/dtheta, and q, the cotangent of the condition projections.
Then the whole backward solve runs on the emulated field through the
port's `models.ode.odeint_dopri5`, as `adjoint_backward` runs it, and is
held to the interpret-mode `cnf_adjoint_bwd_pallas` at 2e-3 (y0, a0, dc,
every parameter gradient) and 5e-5 (the field and its trace at t1), its
step counts to `cnf_adjoint_bwd_plain`'s. The kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
Sizes: 1 x 60 rows, as tests/test_torch_adjoint.py.
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
from puflow_tpu.ops.pallas.cnf_adjoint_pallas import cnf_adjoint_bwd_pallas
from torch_threads import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
H, LDP = 64, 264
ROWS = 60
T1 = 0.47
# the kernel's offsets in the pack (`cnf_field.cuh`, `cnf_adjoint.cu`)
OWN, FRAG = 4873, 4876
# the projections of a condition row: gate1 | bias1 | gate2 | bias2 |
# gate3 | bias3
PROJ = [(0, 64, 64, 128), (128, 192, 192, 256), (256, 259, 259, 262)]


def _rand(seed, *shape, scale):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _maxrel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


def _split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _mm3(a, b):
    """a [M, K] @ b [K, N] (K a multiple of 8) as 3xTF32 products: k chunks
    of 8 in order, each hi*hi + hi*lo + lo*hi accumulated in f32."""
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


def _tiles(x, tile):
    """[R, ...] -> [T, tile, ...], zero rows past the last."""
    pad = -x.shape[0] % tile
    x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return x.view(-1, tile, *x.shape[1:])


def _colsum(x, tile):
    """Sum of x [R, N] over its rows in the kernel's order."""
    g = _tiles(x, tile).view(-1, tile // 4, 4, x.shape[1])   # row 4 i + rg
    v = g[:, 0]
    for i in range(1, tile // 4):
        v = v + g[:, i]
    w = ((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3]
    out = w[0]
    for t in range(1, w.shape[0]):
        out = out + w[t]
    return out


def _rowsum16(x, tile):
    """Sum of x [R, N] over its rows as layer 3's vectors take it: rows 16
    apart in order, a butterfly (xor 8, 4, 2, 1) over the 16 lanes, then
    the tiles."""
    t = _tiles(x, tile).view(-1, tile // 16, 16, x.shape[1])
    v = 0 + t[:, 0]
    for i in range(1, tile // 16):
        v = v + t[:, i]
    idx = torch.arange(16)
    for off in (8, 4, 2, 1):
        v = v + v[:, idx ^ off]
    out = v[0, 0]
    for t in range(1, v.shape[0]):
        out = out + v[t, 0]
    return out


def _grad_w2(pairs, tile):
    """sum_(X, D) X^T D over the rows as the kernel takes W2's gradient: per
    tile one accumulator over the pairs' k chunks of 8 rows, the tiles
    added in order."""
    tiles = [(_tiles(x, tile), _tiles(d, tile)) for x, d in pairs]
    out = None
    for t in range(tiles[0][0].shape[0]):
        acc = torch.zeros(H, H)
        for x, d in tiles:
            xh, xl = _split(x[t].t().contiguous())
            dh, dl = _split(d[t])
            for k in range(0, tile, 8):
                k = slice(k, k + 8)
                acc = acc + xh[:, k] @ dh[k]
                acc = acc + xh[:, k] @ dl[k]
                acc = acc + xl[:, k] @ dh[k]
        out = acc if out is None else out + acc
    return out


class Pack:
    """What the kernel reads of a net, from `ops.cnf._adjoint_pack`."""

    def __init__(self, layers, cdim):
        self.cdim, self.cpad = cdim, cdim + (-cdim % 16)
        weights, wct = t_cnf._adjoint_pack(layers, self.cpad)
        own = weights[:OWN]
        self.w1 = own[0:192].view(3, H)
        self.b1, self.gt1, self.bt1 = own[192:384].view(3, H)
        self.w2 = _unfrag(weights[FRAG:FRAG + H * H], H, H)
        self.w2t = _unfrag(weights[FRAG + H * H:], H, H)
        assert torch.equal(self.w2t, self.w2.t())
        self.b2, self.gt2, self.bt2 = own[4480:4672].view(3, H)
        self.w3 = own[4672:4864].view(H, 3)
        self.b3, self.gt3, self.bt3 = own[4864:4873].view(3, 3)
        self.wct = _unfrag(wct, LDP, self.cpad)          # [264, cpad]
        _, self.wc, self.bc = t_cnf._pack(layers)       # [cdim, 262], [262]


def _aug_field(pk, c, rep, t, y, a, ap, trace):
    """One evaluation of the augmented field in the kernel's arithmetic on
    rows y, a [R, 3], ap [R, 1] with conditions c [R / rep, cdim] ->
    (f, -div or None, -dS/dy, dS/dtheta as per-layer dicts, dS/dc per row
    of y, q [R, 262])."""
    t = torch.as_tensor(t, dtype=torch.float32)
    tile = 16 if trace else 32
    proj = torch.addmm(pk.bc, c, pk.wc).repeat_interleave(rep, 0)
    pg1, pb1 = proj[:, 0:64], proj[:, 64:128]
    pg2, pb2 = proj[:, 128:192], proj[:, 192:256]
    pg3, pb3 = proj[:, 256:259], proj[:, 259:262]
    # forward, and the tangents u1_k, v2_k
    h1 = y @ pk.w1 + pk.b1
    s1 = torch.sigmoid(t * pk.gt1 + pg1)
    x1 = torch.tanh(h1 * s1 + (t * pk.bt1 + pb1))
    m1 = 1 - x1 * x1
    h2 = _mm3(x1, pk.w2) + pk.b2
    s2 = torch.sigmoid(t * pk.gt2 + pg2)
    x2 = torch.tanh(h2 * s2 + (t * pk.bt2 + pb2))
    m2 = 1 - x2 * x2
    h3 = x2 @ pk.w3 + pk.b3
    s3 = torch.sigmoid(t * pk.gt3 + pg3)
    f = h3 * s3 + (t * pk.bt3 + pb3)
    if trace:
        u1 = [pk.w1[k] * (s1 * m1) for k in range(3)]
        v2 = [_mm3(u, pk.w2) for u in u1]
        v3 = torch.stack([(v2[k] * s2 * m2) @ pk.w3[:, k] for k in range(3)],
                         -1)
        neg_div = -(v3 * s3).sum(-1, keepdim=True)
    # layer 3's cotangents
    dh3 = a * s3
    cs3 = -ap * v3 if trace else 0.0
    q3g = (a * h3 + cs3) * s3 * (1 - s3)
    # layer 2's
    cx2 = dh3 @ pk.w3.t()
    cs2 = 0.0
    if trace:
        ck = [-ap[:, 0:1] * s3[:, k:k + 1] for k in range(3)]
        cu = [ck[k] * pk.w3[:, k] for k in range(3)]
        cv2 = [cu[k] * m2 * s2 for k in range(3)]
        cm = sum(cu[k] * (v2[k] * s2) for k in range(3))
        cs2 = sum(cu[k] * m2 * v2[k] for k in range(3))
        cx2 = cx2 - 2 * x2 * cm
    dz2 = cx2 * m2
    dh2 = dz2 * s2
    q2g = (dz2 * h2 + cs2) * s2 * (1 - s2)
    # layer 1's
    cx1 = _mm3(dh2, pk.w2t)
    cs1 = 0.0
    if trace:
        cu1 = [_mm3(v, pk.w2t) for v in cv2]
        cv1 = [cu1[k] * m1 * s1 for k in range(3)]
        cm1 = sum(cu1[k] * (pk.w1[k] * s1) for k in range(3))
        cs1 = sum(cu1[k] * m1 * pk.w1[k] for k in range(3))
        cx1 = cx1 - 2 * x1 * cm1
    dz1 = cx1 * m1
    dh1 = dz1 * s1
    q1g = (dz1 * h1 + cs1) * s1 * (1 - s1)
    neg_dsdy = -(dh1 @ pk.w1.t())
    q = torch.cat([q1g, dz1, q2g, dz2, q3g, a], -1)
    # the layers' gradients
    w1 = torch.stack([_colsum(y[:, k:k + 1] * dh1 + (cv1[k] if trace else 0),
                              tile) for k in range(3)])
    pairs = [(x1, dh2)] + (list(zip(u1, cv2)) if trace else [])
    u2c = ([v2[k] * s2 * m2 * ck[k] for k in range(3)] if trace
           else [0.0] * 3)
    w3 = torch.stack([_colsum(x2 * dh3[:, k:k + 1] + u2c[k], tile)
                      for k in range(3)], -1)
    vec = [tuple(_colsum(v, tile) for v in (dh1, q1g, dz1)),
           tuple(_colsum(v, tile) for v in (dh2, q2g, dz2)),
           tuple(_rowsum16(v, tile) for v in (dh3, q3g, a))]
    # the condition cotangents: c^T Q with Q summed over the repeats, and
    # Wc q per row of y
    qr = q.view(-1, rep, 262)
    qc = qr[:, 0]
    for i in range(1, rep):
        qc = qc + qr[:, i]
    kpad = -qc.shape[0] % 8
    cp = torch.cat([c, c.new_zeros(kpad, c.shape[1])])
    qp = torch.cat([qc, qc.new_zeros(kpad, 262)])
    dwc = _mm3(cp.t(), torch.nn.functional.pad(qp, (0, 2)))[:, :262]
    dc = _mm3(torch.nn.functional.pad(q, (0, 2)), pk.wct)[:, :pk.cdim]
    grads = []
    for (db, qg, dz), w, (g0, g1, b0, b1) in zip(
            vec, (w1, _grad_w2(pairs, tile), w3), PROJ):
        grads.append({"layer": {"w": w, "b": db},
                      "hyper_gate": {"w": torch.cat([(t * qg)[None],
                                                     dwc[:, g0:g1]]),
                                     "b": qg},
                      "hyper_bias": {"w": torch.cat([(t * dz)[None],
                                                     dwc[:, b0:b1]])}})
    return f, neg_div if trace else None, neg_dsdy, grads, dc, q


def _case(trace, cdim, rep):
    layers = jax.tree.map(np.asarray, j_cont.odenet_init(KEY, 3, cdim))
    tl = jax.tree.map(lambda v: torch.tensor(np.asarray(v)), layers)
    c = _rand(1, ROWS // rep, cdim, scale=0.5)
    y = _rand(2, ROWS, 3, scale=0.5)
    a = _rand(3, ROWS, 3, scale=0.3)
    ap = (_rand(4, ROWS, 1, scale=0.3) if trace
          else np.zeros((ROWS, 1), np.float32))
    logp = _rand(5, ROWS, 1, scale=0.1)
    return layers, tl, c, y, a, ap, logp


def _j_field(trace):
    if trace:
        return lambda p, t, s: j_cont.field_with_exact_div(p["layers"],
                                                           p["c"])(t, s)
    return lambda p, t, y: j_cont.odenet_apply(p["layers"], t, p["c"], y)


def _j_q(layers, proj, t, y, a, ap, trace):
    """JAX's q: the gradient of S = a . f - a_p . div with respect to the
    condition projections of each row, the field written on them."""
    def field(pr, yy):
        dx = yy
        for i, (p, (g0, g1, b0, b1)) in enumerate(zip(layers, PROJ)):
            gate = jax.nn.sigmoid(t * p["hyper_gate"]["w"][0] + pr[:, g0:g1])
            bias = t * p["hyper_bias"]["w"][0] + pr[:, b0:b1]
            dx = (dx @ p["layer"]["w"] + p["layer"]["b"]) * gate + bias
            if i < 2:
                dx = jnp.tanh(dx)
        return dx

    def s_fn(pr):
        s = jnp.sum(a * field(pr, y))
        if trace:
            div = sum(jax.jvp(lambda yy: field(pr, yy), (y,),
                              (jnp.zeros_like(y).at[:, k].set(1.0),))[1][:, k]
                      for k in range(3))
            s = s - jnp.sum(ap[:, 0] * div)
        return s

    return jax.grad(s_fn)(proj)


CASES = [(True, 32, 1), (True, 128, 4), (False, 32, 4), (False, 128, 1)]


@pytest.mark.parametrize("trace,cdim,rep", CASES)
def test_adjoint_field_tf32_matches_jax(trace, cdim, rep):
    """One augmented-field evaluation in the kernel's arithmetic against
    `jax.vjp` of JAX's field at the same point: 5e-5 max-relative on f,
    -div, -dS/dy, every leaf of dS/dtheta and q."""
    layers, tl, c, y, a, ap, logp = _case(trace, cdim, rep)
    t = 0.31
    f, neg_div, neg_dsdy, grads, dc, q = _aug_field(
        Pack(tl, cdim), torch.tensor(c), rep, t, torch.tensor(y),
        torch.tensor(a), torch.tensor(ap), trace)
    c_rep = np.repeat(c, rep, axis=0)
    params = {"layers": layers, "c": jnp.asarray(c_rep)}
    state = (jnp.asarray(y), jnp.asarray(logp)) if trace else jnp.asarray(y)
    cot = (jnp.asarray(a), jnp.asarray(ap)) if trace else jnp.asarray(a)
    dy, vjp_fn = jax.vjp(lambda pp, ss: _j_field(trace)(pp, t, ss), params,
                         state)
    p_bar, y_bar = vjp_fn(cot)
    checks = [(f, dy[0] if trace else dy),
              (neg_dsdy, -(y_bar[0] if trace else y_bar)),
              (dc, p_bar["c"])]
    if trace:
        checks.append((neg_div, dy[1]))
    checks += list(zip(jax.tree.leaves(grads),
                       jax.tree.leaves(p_bar["layers"])))
    proj = jnp.asarray(np.repeat(np.asarray(c @ np.concatenate(
        [np.concatenate([p["hyper_gate"]["w"][1:], p["hyper_bias"]["w"][1:]],
                        1) for p in layers], 1) + np.concatenate(
        [np.concatenate([p["hyper_gate"]["b"], np.zeros_like(
            p["hyper_gate"]["b"])]) for p in layers])), rep, axis=0))
    checks.append((q, _j_q(layers, proj, t, jnp.asarray(y), jnp.asarray(a),
                           jnp.asarray(ap), trace)))
    for got, ref in checks:
        assert _maxrel(got.numpy(), ref) < 5e-5


@pytest.mark.parametrize("trace,cdim,rep", CASES)
def test_adjoint_solve_tf32_matches_jax_kernel(trace, cdim, rep):
    """The backward solve on the emulated field against the interpret-mode
    `cnf_adjoint_bwd_pallas`: y0, a0, dc and every parameter gradient
    within 2e-3 max-relative, the field and its trace at t1 within 5e-5;
    its step counts equal `cnf_adjoint_bwd_plain`'s."""
    layers, tl, c, y, a, ap, logp = _case(trace, cdim, rep)
    pk = Pack(tl, cdim)
    ct = torch.tensor(c)

    def aug(t, state):
        if trace:
            (yy, _), (aa, app), _ = state
        else:
            (yy, aa, _), app = state, torch.zeros(ROWS, 1)
        f, neg_div, neg_dsdy, grads, dc, _ = _aug_field(pk, ct, rep, t, yy,
                                                        aa, app, trace)
        neg_g = {"layers": t_cnf._like(tl, [jax.tree.map(torch.neg, g)
                                            for g in grads]),
                 "c": -dc}
        if trace:
            return ((f, neg_div), (neg_dsdy, torch.zeros_like(app)), neg_g)
        return f, neg_dsdy, neg_g

    g0 = {"layers": t_cnf._like(tl, jax.tree.map(torch.zeros_like, tl)),
          "c": torch.zeros(ROWS, cdim)}
    y1, a1, ap1 = torch.tensor(y), torch.tensor(a), torch.tensor(ap)
    state1 = (((y1, torch.tensor(logp)), (a1, ap1), g0) if trace
              else (y1, a1, g0))
    out, stats = t_odeint(aug, state1, torch.tensor(T1), torch.tensor(0.0),
                          1e-5, 1e-5, 128, differentiable=False,
                          return_stats=True)
    y0, a0 = (out[0][0], out[1][0]) if trace else (out[0], out[1])
    g = out[2]
    dc = g["c"].view(-1, rep, cdim).sum(1)
    f1, neg_div1 = _aug_field(pk, ct, rep, T1, y1, a1, ap1, trace)[:2]

    _, ref_stats = t_cnf.cnf_adjoint_bwd_plain(
        tl, ct[None], y1[None], a1[None], ap1[None], 0.0, T1,
        with_trace=trace, logp1=torch.tensor(logp)[None] if trace else None,
        return_stats=True)[4:]
    assert [stats["steps"], stats["accepted"]] == [ref_stats["steps"],
                                                   ref_stats["accepted"]]

    ref = cnf_adjoint_bwd_pallas(layers, np.repeat(c, rep, axis=0)[None],
                                 y[None], a[None], ap[None], 0.0, T1, 1e-5,
                                 1e-5, 128, True, None, trace)
    ref_dc = np.asarray(ref[2])[0].reshape(-1, rep, cdim).sum(1)
    for got, r in ((y0, ref[0][0]), (a0, ref[1][0]), (dc, ref_dc)):
        assert _maxrel(got.numpy(), r) < 2e-3
    for got, r in zip(jax.tree.leaves(g["layers"]), jax.tree.leaves(ref[3])):
        assert _maxrel(got.numpy(), r) < 2e-3
    assert _maxrel(f1.numpy(), ref[4][0][0]) < 5e-5
    if trace:
        assert _maxrel((-neg_div1).numpy(), ref[4][1][0]) < 5e-5
