"""The inverse-flow kernel's 3xTF32 arithmetic, checked on the CPU.

`csrc/flow_g.cu` takes every product of the injector and coupling MLPs
on the tensor cores as 3xTF32 (hi = tf32(x), lo = tf32(x - hi), a product
is hi*hi + hi*lo + lo*hi with f32 accumulation; `csrc/mma_tf32.cuh`).
Here `_emulate` runs that arithmetic in torch, reading each block's
weights from the packing the kernel reads (`ops.flow._pack`, inverse) at
the kernel's offsets (tests/torch_flow_cases.py), with the kernel's order
of steps: the condition-only nets once per point, the coupling's first
layer as the point's projection plus the h1 columns in f32, the 64 x 64
layers pre-split as packed, the other weights split as read.
Flow g and flow g with the latent blend are held to JAX's interpret-mode
`flow_g_pallas` at FLOW_PASSES=3 (set and restored as
tests/test_torch_flow_kernels.py does) and to `g_transform(fast=False)`
at atol 1e-5 * max(1, max|ref|), the JAX package's own 3-pass g bound
(tests/test_fused_kernels.py:263-264). The kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Parameters: the full-width JAX `discrete.init`, `perturb_init`; 2
patches of 64 points, r = 1 and 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from puflow_torch.ops import _build
from puflow_torch.ops import flow as t_flow
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.models.encoder import interpolation_apply
from puflow_tpu.ops.pallas import flow_pallas
from torch_flow_cases import (B, N, HEAD, W0H, block_nets, check,
                              check_block_layout, coupling_net,
                              injector_nets, make_case)
from torch_threads import one_torch_thread  # noqa: F401

K = 8


@pytest.fixture(scope="module")
def case():
    return make_case()


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


def _emulate(weights, woff, cs, z, r):
    """The kernel's arithmetic on the state rows ``z`` [P * r, 3]
    (point-major) after the prologue, the weights read from the pack."""
    z = z.clone()
    for b in reversed(range(len(cs))):
        w = weights[woff[b]:woff[b + 1]]
        c = cs[b].reshape(-1, cs[b].shape[-1])
        kp = 8 * t_flow.k_chunks(c.shape[1])
        split = 1 if b % 2 == 0 else 2
        m = block_nets(w, kp)
        cp = F.pad(c, (0, kp - c.shape[1]))
        sc, bi = injector_nets(m, w, cp)
        esc = torch.exp(sc).repeat_interleave(r, 0)
        bi = bi.repeat_interleave(r, 0)
        cp = cp.repeat_interleave(r, 0)
        v = (z * esc + bi).flip(-1)
        add = coupling_net(m, w, cp, v, split)
        v = torch.cat([v[:, :split], v[:, split:] + add], 1)
        head = w[HEAD:W0H]
        z = (v @ head[6:15].reshape(3, 3).T - head[:3]) * head[3:6]
    return z


@pytest.mark.parametrize("r", [1, 4])
def test_emulated_flow_g_meets_the_exact_bound(case, r):
    fz, _ = interpolation_apply(case["jp"]["interp"], case["js"]["interp"],
                                case["z"], jnp.asarray(case["x"]), r, False,
                                knn_idx=case["idx"])
    fz = np.array(fz)
    weights, woff = t_flow._pack(case["blocks"], inverse=True)
    rows = torch.from_numpy(fz).transpose(2, 3).reshape(-1, 3)
    got = _emulate(weights, woff, case["t_cs"], rows, r)
    got = got.reshape(B, N * r, 3).numpy()
    plain = t_flow.flow_g_plain(case["blocks"], torch.from_numpy(fz),
                                case["t_cs"]).numpy()
    assert not np.array_equal(got, plain)   # the products did change
    check(got, _jax_refs(case, fz), f"flow g r={r}")


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
    weights, woff = t_flow._pack(case["blocks"], inverse=True)
    got = _emulate(weights, woff, case["t_cs"], v.reshape(-1, 3), r)
    check(got.reshape(B, N * r, 3).numpy(), _jax_refs(case, fz),
          f"flow g blend r={r}")


def test_pack_g_lays_out_every_block(case):
    """Per block: the head (ActNorm bias, exp(-logs), W^-1) as the kernel
    reads it, and the rest of the block as `check_block_layout` holds it
    (c_w0's h1 rows, the biases, every fragment run undone)."""
    weights, woff = t_flow._pack(case["blocks"], inverse=True)
    assert all(o % 4 == 0 for o in woff)
    for i, bp in enumerate(case["blocks"]):
        w = weights[woff[i]:woff[i + 1]]
        an = bp["actnorm"]
        w_inv = torch.linalg.inv(bp["inv1x1"]["W"])
        np.testing.assert_array_equal(w[:3].numpy(),
                                      an["bias"].reshape(-1).numpy())
        np.testing.assert_array_equal(
            w[3:6].numpy(), torch.exp(-an["logs"]).reshape(-1).numpy())
        np.testing.assert_allclose(w[6:15].numpy(),
                                   w_inv.reshape(-1).numpy(), rtol=1e-6)
        assert float(w[15]) == 0.0
        check_block_layout(w, bp, 1 if i % 2 == 0 else 2)


def test_flow_packs_are_cached_per_parameters(case):
    """f and g pack the same blocks apart (one layout, other heads); each
    pack is made once and made again after an in-place update of a
    weight."""
    blocks = [{k: {kk: (vv.clone() if torch.is_tensor(vv) else
                        {n: t.clone() for n, t in vv.items()})
                   for kk, vv in v.items()}
               for k, v in bp.items()} for bp in case["blocks"]]
    g1, _ = t_flow._packed(blocks, inverse=True)
    f1, _ = t_flow._packed(blocks, inverse=False)
    assert g1.numel() == f1.numel() and not torch.equal(g1, f1)
    assert t_flow._packed(blocks, inverse=True)[0] is g1
    assert t_flow._packed(blocks, inverse=False)[0] is f1
    blocks[2]["coupling1"]["bias_net"]["w1"].mul_(1.5)
    g2, woff = t_flow._packed(blocks, inverse=True)
    assert g2 is not g1
    np.testing.assert_array_equal(
        g2.numpy(), t_flow._pack(blocks, inverse=True)[0].numpy())
    assert not torch.equal(g2, g1)
    f2 = t_flow._packed(blocks, inverse=False)[0]
    assert f2 is not f1
    np.testing.assert_array_equal(
        f2.numpy(), t_flow._pack(blocks, inverse=False)[0].numpy())
    assert not torch.equal(f2, f1)
    _build._PACKS.clear()
