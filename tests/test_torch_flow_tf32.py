"""The inverse-flow kernel's 3xTF32 arithmetic, checked on the CPU.

`csrc/flow_g.cu` takes every product of the injector and coupling MLPs
on the tensor cores as 3xTF32 (hi = tf32(x), lo = tf32(x - hi), a product
is hi*hi + hi*lo + lo*hi with f32 accumulation; `csrc/mma_tf32.cuh`).
Here `_emulate` runs that arithmetic in torch, reading each block's
weights from the packing the kernel reads (`ops.flow._pack_g`) at the
kernel's offsets, with the kernel's order of steps: the condition-only
nets once per point, the coupling's first layer as the point's projection
plus the h1 columns in f32, the 64 x 64 layers pre-split as packed, the
other weights split as read.
Flow g and flow g with the latent blend are held to JAX's interpret-mode
`flow_g_pallas` at FLOW_PASSES=3 (set and restored as
tests/test_torch_flow_kernels.py does) and to `g_transform(fast=False)`
at atol 1e-5 * max(1, max|ref|), the JAX package's own 3-pass g bound
(tests/test_fused_kernels.py:263-264). The kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Parameters: the full-width JAX `discrete.init`, `perturb_init`; 2
patches of 64 points, r = 1 and 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.models import discrete as t_discrete
from puflow_torch.ops import _build
from puflow_torch.ops import flow as t_flow
from puflow_torch.ops.encoder import split_tf32, tf32_round
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.models.encoder import interpolation_apply
from puflow_tpu.ops.knn import knn_indices
from puflow_tpu.ops.pallas import flow_pallas
from torch_threads import one_torch_thread  # noqa: F401

B, N, K = 2, 64, 8
# offsets of a block's weights in csrc/flow_g.cu (kW0h ... kFrags)
HEAD, W0H, CB1, SB1, BB1, CB2, SB2, BB2, FRAGS = (0, 16, 144, 208, 272, 336,
                                                  344, 352, 360)


@pytest.fixture(scope="module")
def case():
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 3)
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    rng = np.random.RandomState(3)
    x = (rng.randn(B, N, 3) * 0.3).astype(np.float32)
    idx = knn_indices(jnp.asarray(x), jnp.asarray(x), 16)
    cs, _ = j_discrete.feat_extract(jp, js, jnp.asarray(x), idx, train=False)
    z, _ = j_discrete.f_transform(jp, jnp.asarray(x), cs)
    model = t_checkpoint.from_numpy_tree(params, state, "cpu")
    return dict(jp=jp, js=js, x=x, idx=idx, cs=cs, z=z,
                blocks=model.trees()[0]["flow_blocks"],
                t_cs=[torch.tensor(np.asarray(c)) for c in cs])


def _jax_refs(case, fz):
    """JAX's interpret-mode kernel at FLOW_PASSES=3 and its XLA form."""
    r = fz.shape[-1]
    fz = jnp.asarray(fz)
    old = flow_pallas.FLOW_PASSES
    try:
        # FLOW_PASSES is read at trace time: clear the jit cache around it
        flow_pallas.FLOW_PASSES = 3
        flow_pallas.flow_g_pallas.clear_cache()
        kernel = np.asarray(flow_pallas.flow_g_pallas(
            case["jp"]["flow_blocks"], fz, case["cs"], True))
    finally:
        flow_pallas.FLOW_PASSES = old
        flow_pallas.flow_g_pallas.clear_cache()
    xla = np.asarray(j_discrete.g_transform(case["jp"], fz, case["cs"], r,
                                            fast=False))
    return {"kernel": kernel, "xla": xla}


def _unfrag(flat, k_in, n_out, presplit):
    """B fragments -> (hi, lo) of the [k_in, n_out] matrix, as the kernel
    takes them: stored (pre-split) or split as read (f32 pairs)."""
    f = flat.reshape(k_in // 8, n_out // 8, 8, 4, 4 if presplit else 2)

    def undo(x):
        return x.permute(0, 3, 4, 1, 2).reshape(k_in, n_out)

    if presplit:
        return undo(f[..., :2]), undo(f[..., 2:])
    return split_tf32(undo(f))


def _product(a, w):
    """``a @ w`` as 3xTF32, w given as (hi, lo)."""
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = w
    return a_hi @ w_hi + a_hi @ w_lo + a_lo @ w_hi


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


def _emulate(weights, woff, cs, z, r):
    """The kernel's arithmetic on the state rows ``z`` [P * r, 3]
    (point-major) after the prologue, the weights read from the pack."""
    z = z.clone()
    for b in reversed(range(len(cs))):
        w = weights[woff[b]:woff[b + 1]]
        c = cs[b].reshape(-1, cs[b].shape[-1])
        kp = 8 * t_flow.g_chunks(c.shape[1])
        split = 1 if b % 2 == 0 else 2
        off = FRAGS

        def take(k_in, n_out, presplit=False):
            nonlocal off
            size = k_in * n_out * (2 if presplit else 1)
            off += size
            return _unfrag(w[off - size:off], k_in, n_out, presplit)

        s_w0, b_w0, c_w0 = (take(kp, 64) for _ in range(3))
        s_w2, b_w2, c_w2 = (take(64, 8) for _ in range(3))
        s_w1, b_w1, c_w1 = (take(64, 64, True) for _ in range(3))
        assert off == w.numel()
        nets = [(s_w0, s_w1, s_w2), (b_w0, b_w1, b_w2)]
        cp = F.pad(c, (0, kp - c.shape[1]))
        out = []
        for (w0, w1, w2), b1, b2 in zip(nets, (w[SB1:BB1], w[BB1:CB2]),
                                        (w[SB2:BB2], w[BB2:FRAGS])):
            h = _lrelu(_product(cp, w0))
            h = _lrelu(_product(h, w1) + b1)
            out.append((_product(h, w2) + b2)[:, :3])
        esc = torch.exp(out[0]).repeat_interleave(r, 0)
        bi = out[1].repeat_interleave(r, 0)
        hc = _product(cp, c_w0).repeat_interleave(r, 0)
        v = (z * esc + bi).flip(-1)
        w0h = w[W0H:CB1].reshape(2, 64)
        h = hc
        for j in range(split):
            h = torch.addcmul(h, v[:, j:j + 1], w0h[j])
        h = _lrelu(_product(_lrelu(h), c_w1) + w[CB1:SB1])
        add = _product(h, c_w2) + w[CB2:SB2]
        v = torch.cat([v[:, :split], v[:, split:] + add[:, :3 - split]], 1)
        head = w[HEAD:W0H]
        z = (v @ head[6:15].reshape(3, 3).T - head[:3]) * head[3:6]
    return z


def _check(got, refs, label):
    for name, ref in refs.items():
        err = float(np.abs(got - ref).max())
        tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
        print(f"{label} vs {name}: {err:.3e} (tol {tol:.3e})")
        assert got.shape == ref.shape
        assert err <= tol, (label, name, err, tol)


@pytest.mark.parametrize("r", [1, 4])
def test_emulated_flow_g_meets_the_exact_bound(case, r):
    fz, _ = interpolation_apply(case["jp"]["interp"], case["js"]["interp"],
                                case["z"], jnp.asarray(case["x"]), r, False,
                                knn_idx=case["idx"])
    fz = np.array(fz)
    weights, woff = t_flow._pack_g(case["blocks"])
    rows = torch.from_numpy(fz).transpose(2, 3).reshape(-1, 3)
    got = _emulate(weights, woff, case["t_cs"], rows, r)
    got = got.reshape(B, N * r, 3).numpy()
    plain = t_flow.flow_g_plain(case["blocks"], torch.from_numpy(fz),
                                case["t_cs"]).numpy()
    assert not np.array_equal(got, plain)   # the products did change
    _check(got, _jax_refs(case, fz), f"flow g r={r}")


@pytest.mark.parametrize("r", [1, 4])
def test_emulated_flow_g_blend_meets_the_exact_bound(case, r):
    """The prologue's blend (sum over the K = 8 neighbours' latents, f32)
    then the flow; the references take the blend in float64."""
    rng = np.random.RandomState(10 + r)
    logits = rng.randn(B, N, K, r)
    ws = np.exp(logits) / np.exp(logits).sum(2, keepdims=True)
    ws = ws.astype(np.float32)
    idx8 = np.asarray(case["idx"])[..., :K]
    z = np.asarray(case["z"])
    nei = z[np.arange(B)[:, None, None], idx8]               # [B, N, K, 3]
    fz = np.einsum("bnkc,bnkr->bncr", nei.astype(np.float64),
                   ws.astype(np.float64)).astype(np.float32)
    # the prologue: v = fmaf(z[q], w[q], v) over q, one row at a time
    zt, wt = torch.from_numpy(nei), torch.from_numpy(ws)
    v = torch.zeros(B, N, r, 3)
    for q in range(K):
        v = torch.addcmul(v, zt[:, :, q, None, :], wt[:, :, q, :, None])
    weights, woff = t_flow._pack_g(case["blocks"])
    got = _emulate(weights, woff, case["t_cs"], v.reshape(-1, 3), r)
    _check(got.reshape(B, N * r, 3).numpy(), _jax_refs(case, fz),
           f"flow g blend r={r}")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def test_pack_g_lays_out_every_block(case):
    """Per block: the head, c_w0's h1 rows and the biases as the kernel
    reads them; every f32 fragment run undoes to its zero-padded weight
    matrix exactly; the 64 x 64 layers' pre-split fragments are tf32
    values, hi is tf32(weight) and hi + lo the weight to 2^-21 of it."""
    weights, woff = t_flow._pack_g(case["blocks"])
    assert all(o % 4 == 0 for o in woff)
    for i, bp in enumerate(case["blocks"]):
        w = weights[woff[i]:woff[i + 1]]
        split = 1 if i % 2 == 0 else 2
        an, c1 = bp["actnorm"], bp["coupling1"]["bias_net"]
        sn, bn = bp["coupling2"]["scale_net"], bp["coupling2"]["bias_net"]
        cdim = sn["w0"].shape[0]
        kp = 8 * t_flow.g_chunks(cdim)
        w_inv = torch.linalg.inv(bp["inv1x1"]["W"])
        np.testing.assert_array_equal(w[:3].numpy(),
                                      an["bias"].reshape(-1).numpy())
        np.testing.assert_array_equal(
            w[3:6].numpy(), torch.exp(-an["logs"]).reshape(-1).numpy())
        np.testing.assert_allclose(w[6:15].numpy(),
                                   w_inv.reshape(-1).numpy(), rtol=1e-6)
        w0h = w[W0H:CB1].reshape(2, 64)
        np.testing.assert_array_equal(w0h[:split].numpy(),
                                      c1["w0"][:split].numpy())
        assert not bool(w0h[split:].any())
        for lo, hi, b in ((CB1, SB1, c1["b1"]), (SB1, BB1, sn["b1"]),
                          (BB1, CB2, bn["b1"]), (CB2, SB2, c1["b2"]),
                          (SB2, BB2, sn["b2"]), (BB2, FRAGS, bn["b2"])):
            np.testing.assert_array_equal(w[lo:lo + b.numel()].numpy(),
                                          b.numpy())
            assert not bool(w[lo + b.numel():hi].any())
        off = FRAGS
        # the f32 runs: the first layers, then the 64 -> 3 layers
        for m in (sn["w0"], bn["w0"], c1["w0"][split:], sn["w2"], bn["w2"],
                  c1["w2"]):
            k_in, n_out = (kp, 64) if m.shape[1] == 64 else (64, 8)
            frag = w[off:off + k_in * n_out].reshape(k_in // 8, n_out // 8,
                                                     8, 4, 2)
            off += k_in * n_out
            back = frag.permute(0, 3, 4, 1, 2).reshape(k_in, n_out)
            np.testing.assert_array_equal(back[:m.shape[0], :m.shape[1]]
                                          .numpy(), m.numpy())
            assert not bool(back[m.shape[0]:].any())
            assert not bool(back[:, m.shape[1]:].any())
        frags = w[off:].reshape(3, 8, 8, 8, 4, 4)
        assert off + frags.numel() == w.numel()
        undo = lambda f: f.permute(0, 3, 4, 1, 2).reshape(64, 64)  # noqa
        for frag, m in zip(frags, (sn["w1"], bn["w1"], c1["w1"])):
            hi, lo = frag[..., :2], frag[..., 2:]
            assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
            assert int((_bits(lo) & 0x1FFF).abs().max()) == 0
            np.testing.assert_array_equal(undo(hi).numpy(),
                                          tf32_round(m).numpy())
            back = undo(hi.double() + lo.double())
            assert bool(((back - m.double()).abs()
                         <= 2.0 ** -21 * m.double().abs()).all())


def test_flow_packs_are_cached_per_parameters(case):
    """f and g pack the same blocks apart; each pack is made once and made
    again after an in-place update of a weight."""
    blocks = [{k: {kk: (vv.clone() if torch.is_tensor(vv) else
                        {n: t.clone() for n, t in vv.items()})
                   for kk, vv in v.items()}
               for k, v in bp.items()} for bp in case["blocks"]]
    g1, _ = t_flow._packed(blocks, inverse=True)
    f1, _ = t_flow._packed(blocks, inverse=False)
    assert g1.numel() != f1.numel()
    assert t_flow._packed(blocks, inverse=True)[0] is g1
    assert t_flow._packed(blocks, inverse=False)[0] is f1
    blocks[2]["coupling1"]["bias_net"]["w1"].mul_(1.5)
    g2, woff = t_flow._packed(blocks, inverse=True)
    assert g2 is not g1
    np.testing.assert_array_equal(
        g2.numpy(), t_flow._pack_g(blocks)[0].numpy())
    assert not torch.equal(g2, g1)
    assert t_flow._packed(blocks, inverse=False)[0] is not f1
    _build._PACKS.clear()
