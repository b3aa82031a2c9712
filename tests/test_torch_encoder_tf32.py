"""The condition encoder's 3xTF32 products, checked on the CPU.

`csrc/encoder.cu` takes the products of its growth layers and conv_out on
the tensor cores as 3xTF32: each f32 operand splits into hi = tf32(x) and
lo = tf32(x - hi), a product is hi*hi + hi*lo + lo*hi with f32
accumulation (`csrc/mma_tf32.cuh`). Here that arithmetic runs in torch:
`ops.encoder.tf32_round` emulates `cvt.rna.tf32.f32`, the plain encoder
with every product so split stays within the JAX package's exact bound of
`puflow_tpu` (tests/test_fused_kernels.py:54, :84), and the wrapper's
weight packing and slot padding keep the function. The kernel itself is
held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Parameters: the full-width JAX `discrete.init`, `perturb_init`, each
package's own `fold_bn_inference`; 2 patches of 64 points, K = 16, as
tests/test_fused_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.models import discrete as t_discrete
from puflow_torch.models import encoder as t_models_encoder
from puflow_torch.models import fold_bn as t_fold
from puflow_torch.models import nn as t_nn
from puflow_torch.ops import encoder as t_encoder
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.models import fold_bn as j_fold
from puflow_tpu.ops.pallas import encoder_pallas, knn_pallas
from torch_threads import one_torch_thread  # noqa: F401

B, N, K = 2, 64, 16


@pytest.fixture(scope="module")
def case():
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 7)
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    tp, ts = t_checkpoint.from_numpy_tree(params, state, "cpu").trees()
    x = (np.random.RandomState(7).randn(B, N, 3) * 0.3).astype(np.float32)
    idx = knn_pallas.knn_self_pallas(jnp.asarray(x), K, True)
    return dict(jf=j_fold.fold_bn_inference(jp, js), js=js,
                tf=t_fold.fold_bn_inference(tp, ts), x=x,
                xt=torch.from_numpy(x), idx=idx,
                idx_t=torch.tensor(np.asarray(idx)).long())


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _product_3x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel takes it: hi*hi + hi*lo + lo*hi, f32."""
    a_hi, a_lo = t_encoder.split_tf32(a)
    b_hi, b_lo = t_encoder.split_tf32(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def test_tf32_round_is_cvt_rna():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(np.concatenate([
        rng.randn(4096) * 10.0 ** rng.randint(-6, 6, 4096),
        [0.0, -0.0, 1.0, -1.0]]).astype(np.float32))
    r = t_encoder.tf32_round(x)
    assert int((_bits(r) & 0x1FFF).abs().max()) == 0
    # nearest of the two tf32 neighbours: within half a tf32 ulp
    # (2^-11 of the value's binade)
    x64, r64 = x.double(), r.double()
    assert bool(((x64 - r64).abs() <= 2.0 ** -11 * x64.abs()).all())
    assert bool((torch.sign(r) == torch.sign(x)).all())
    # ties away from zero: 1 + 2^-11 (exactly half way) -> 1 + 2^-10
    half = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                         1 + 3 * 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -23])
    np.testing.assert_array_equal(
        t_encoder.tf32_round(half).numpy(),
        np.float32([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2 * 2.0 ** -10,
                    1.0]))


@pytest.mark.parametrize("k_in,n_out", [(32, 8), (64, 16), (128, 32),
                                        (128, 128), (256, 128)])
def test_3x_tf32_products_reconstruct_f32(k_in, n_out):
    """At the encoder's contraction widths, each 3-term product is the f32
    product to 2^-20 of it, and a 3-term matrix product (its terms summed
    in float64) the f32 one to 2^-20 of |a| @ |b|."""
    rng = np.random.RandomState(k_in + n_out)
    a = torch.from_numpy(rng.randn(64, k_in).astype(np.float32))
    b = torch.from_numpy((rng.randn(k_in, n_out) / 8).astype(np.float32))
    a_hi, a_lo = t_encoder.split_tf32(a)
    b_hi, b_lo = t_encoder.split_tf32(b)
    for hi, lo, v in ((a_hi, a_lo, a), (b_hi, b_lo, b)):
        assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
        assert int((_bits(lo) & 0x1FFF).abs().max()) == 0
        assert bool(((hi.double() + lo.double() - v.double()).abs()
                     <= 2.0 ** -21 * v.double().abs()).all())
    d = lambda t: t.double()  # noqa: E731
    scalar = (d(a_hi[:, :1]) * d(b_hi[:1]) + d(a_hi[:, :1]) * d(b_lo[:1])
              + d(a_lo[:, :1]) * d(b_hi[:1]))
    exact = d(a[:, :1]) * d(b[:1])
    assert bool(((scalar - exact).abs() <= 2.0 ** -20 * exact.abs()).all())
    got = d(a_hi) @ d(b_hi) + d(a_hi) @ d(b_lo) + d(a_lo) @ d(b_hi)
    ref = d(a) @ d(b)
    assert bool(((got - ref).abs() <= 2.0 ** -20 * (d(a).abs()
                                                    @ d(b).abs())).all())


def test_encoder_with_3x_tf32_products_meets_the_exact_bound(case,
                                                             monkeypatch):
    """Every product of the plain encoder (projections, growth layers,
    conv_out, merge MLPs) taken as 3xTF32 stays within the JAX package's
    exact bound of its interpret-mode kernel and of its XLA encoder."""
    x, idx = jnp.asarray(case["x"]), case["idx"]
    refs = {
        "kernel": [np.swapaxes(np.asarray(c), 1, 2) for c in
                   encoder_pallas.encoder_conditions_pallas_cm(
                       case["jf"], x, idx, 1, True,
                       encoder_pallas.EXACT_PRECISION)],
        "xla": [np.asarray(c) for c in j_discrete.feat_extract(
            case["jf"], case["js"], x, idx, train=False)[0]],
    }
    exact = [c.numpy() for c in t_encoder.encoder_conditions_plain(
        case["tf"], case["xt"], case["idx_t"])]
    monkeypatch.setattr(t_nn, "channel_matmul", _product_3x)
    monkeypatch.setattr(t_models_encoder, "channel_matmul", _product_3x)
    got = [c.numpy() for c in t_encoder.encoder_conditions_plain(
        case["tf"], case["xt"], case["idx_t"])]
    # the products did change
    assert any(not np.array_equal(a, b) for a, b in zip(got, exact))
    for name, ref in refs.items():
        for i, (a, b) in enumerate(zip(got, ref)):
            assert a.shape == b.shape
            err, scale = np.abs(a - b).max(), np.abs(b).max()
            print(f"3xTF32 vs {name} block {i}: {err:.3e} (scale "
                  f"{scale:.4f}, relative {err / scale:.3e})")
            # tests/test_fused_kernels.py:54, :84
            assert err < 5e-5 * scale + 1e-4, (name, i, err, scale)


def test_pack_splits_and_permutes_the_weights(case):
    """The packed B fragments of every product: hi and lo are tf32 values,
    hi + lo is the weight to 2^-21 of it, hi is tf32(weight) exactly, and
    undoing the fragment order gives each weight matrix back; the biases
    come in the kernel's order."""
    fp = case["tf"]
    weights, meta = t_encoder._pack(fp)
    assert len(meta) == 10 * len(fp["feat_convs"])

    def check_run(off, mats):
        assert off % 4 == 0
        for w in mats:
            k_in, n_out = w.shape
            frag = weights[off:off + 2 * w.numel()].reshape(
                k_in // 8, n_out // 8, 8, 4, 4)
            off += 2 * w.numel()
            hi, lo = frag[..., :2], frag[..., 2:]
            assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
            assert int((_bits(lo) & 0x1FFF).abs().max()) == 0

            def unorder(f, k_in=k_in, n_out=n_out):
                return f.permute(0, 3, 4, 1, 2).reshape(k_in, n_out)

            np.testing.assert_array_equal(unorder(hi).numpy(),
                                          t_encoder.tf32_round(w).numpy())
            back = unorder(hi.double() + lo.double())
            assert bool(((back - w.double()).abs()
                         <= 2.0 ** -21 * w.double().abs()).all())

    for b, (block, merge) in enumerate(zip(fp["feat_convs"],
                                           fp["merge_convs"])):
        c, g, n_layers, odim, cdim, bias, b1, proj, mlp, edge = \
            meta[10 * b:10 * (b + 1)]
        layers = [conv["lin"] for conv in block["convs"]] + [block["conv_out"]]
        np.testing.assert_array_equal(
            weights[bias:bias + n_layers * g + odim].numpy(),
            torch.cat([lay["b"] for lay in layers]).numpy())
        np.testing.assert_array_equal(weights[b1:b1 + odim // 2].numpy(),
                                      merge["conv1"]["b"].numpy())
        w_proj = torch.cat([lay["w"][:c] - lay["w"][2 * c:3 * c]
                            for lay in layers]
                           + [lay["w"][c:2 * c] + lay["w"][2 * c:3 * c]
                              for lay in layers], dim=1)
        w_proj = torch.cat([w_proj, torch.zeros(-c % 8, w_proj.shape[1])])
        check_run(proj, w_proj.split(128, dim=1))
        check_run(mlp, [merge["conv1"]["w"], merge["conv2"]["w"]])
        check_run(edge, [lay["w"][3 * c:] for lay in layers[1:]])


@pytest.mark.parametrize("k", [8, 12])
def test_slot_padding_keeps_the_conditions(case, k):
    """K = 8 and 12 padded to 16 slots (each point's first neighbour
    repeated) give the plain encoder's conditions bit for bit."""
    idx = case["idx_t"][..., :k]
    padded = t_encoder.pad_slots(idx)
    assert padded.shape == (B, N, 16)
    np.testing.assert_array_equal(padded[..., :k].numpy(), idx.numpy())
    assert bool((padded[..., k:] == idx[..., :1]).all())
    assert t_encoder.pad_slots(case["idx_t"]) is case["idx_t"]
    ref = t_encoder.encoder_conditions_plain(case["tf"], case["xt"], idx)
    got = t_encoder.encoder_conditions_plain(case["tf"], case["xt"], padded)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
