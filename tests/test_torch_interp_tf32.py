"""The interpolation-head kernel's 3xTF32 arithmetic, checked on the CPU.

`csrc/interp.cu` takes every product of the head's distance MLP, context
EdgeConv and weight MLP on the tensor cores as 3xTF32 (hi = tf32(x), lo =
tf32(x - hi), a product is hi*hi + hi*lo + lo*hi with f32 accumulation;
`csrc/mma_tf32.cuh`). Here `_emulate` runs that arithmetic in torch,
reading the weights from the packing the kernel reads (`ops.interp._pack`)
phase by phase, in the kernel's order of steps: f10 zero-padded to 16
columns, the growth layers on it, each group of 32 columns of e and then
of d added into the weight MLP's first layer as soon as it is made, the
tail, then the softmax over the slots (and the blend) in f32.
All three modes are held to the JAX package's exact head, the XLA
`knn_context_apply` + `weight_unit_apply` + softmax built as
tests/test_fused_kernels.py:99-185 builds it, at its gates (2e-3 logits,
5e-4 weights, 5e-4 latents), and to the port's plain version run in
float64 at 1e-5 of the logits' scale, the 3xTF32 level. The kernel itself
is held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Parameters: the full-width JAX `discrete.init`, `perturb_init`, each
package's own `fold_bn_inference`; 2 patches of 64 points, K = 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.models import discrete as t_discrete
from puflow_torch.models import fold_bn as t_fold
from puflow_torch.ops import _build
from puflow_torch.ops import interp as t_interp
from puflow_torch.ops.encoder import split_tf32, tf32_round
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.models import fold_bn as j_fold
from puflow_tpu.models.encoder import knn_context_apply, weight_unit_apply
from puflow_tpu.ops.knn import knn_indices
from torch_threads import one_torch_thread  # noqa: F401

B, N, K = 2, 64, 8
# the JAX package's gates for the exact head (tests/test_fused_kernels.py:
# 149, 125, 183)
GATES = {"logits": 2e-3, "weights": 5e-4, "latents": 5e-4}


@pytest.fixture(scope="module")
def case():
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 5)
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    tp, ts = t_checkpoint.from_numpy_tree(params, state, "cpu").trees()
    rng = np.random.RandomState(5)
    x = (rng.randn(B, N, 3) * 0.3).astype(np.float32)
    z = rng.randn(B, N, 3).astype(np.float32)
    idx = knn_indices(jnp.asarray(x), jnp.asarray(x), K)
    ip = j_fold.fold_bn_inference(jp, js)["interp"]
    istate = j_fold.empty_bn_state(js)["interp"]
    ctx, _ = knn_context_apply(ip["knn_context"], istate["knn_context"],
                               jnp.asarray(x), idx, False)
    logits, _ = weight_unit_apply(ip["weight_unit"], istate["weight_unit"],
                                  ctx, False)
    nei = np.asarray(z)[np.arange(B)[:, None, None], np.asarray(idx)]
    return dict(head=t_fold.fold_bn_inference(tp, ts)["interp"],
                x=torch.from_numpy(x), z=torch.from_numpy(z),
                idx=torch.tensor(np.asarray(idx)).long(),
                logits=np.asarray(logits), nei=nei)


def _jax_ref(case, mode, r):
    """The XLA head's logits, softmax and blend, as
    tests/test_fused_kernels.py:99-185."""
    if mode == "logits":
        return case["logits"]
    w = np.asarray(jax.nn.softmax(jnp.asarray(case["logits"][..., :r]),
                                  axis=2))
    if mode == "weights":
        return w
    return np.einsum("bnkc,bnkr->bncr", case["nei"], w)


def _unfrag(flat, k_in, n_out):
    """B fragments -> (hi, lo) of the [k_in, n_out] matrix, as the kernel
    takes them: stored (pre-split) or split as read (f32 pairs)."""
    width = 4 if t_interp._PRESPLIT else 2
    f = flat.reshape(k_in // 8, n_out // 8, 8, 4, width)

    def undo(x):
        return x.permute(0, 3, 4, 1, 2).reshape(k_in, n_out)

    if t_interp._PRESPLIT:
        return undo(f[..., :2]), undo(f[..., 2:])
    return split_tf32(undo(f))


def _phase_mats(weights, offsets):
    """Each phase's matrices, (hi, lo) as the kernel reads them from the
    pack, in `_phases`'s order; and the biases."""
    shapes = [[(16 + 16 * j, 16) for j in range(8)],
              *([(144, 32), (32, 128)] for _ in range(4)),
              [(16, 64), (64, 64), (64, 32), (32, 128)],
              [(64, 32), (32, 128)] * 2, [(64, 32), (32, 128)],
              [(128, 64), (64, 32)]]
    width = 2 if t_interp._PRESPLIT else 1
    phases = []
    for i, phase in enumerate(shapes):
        pos = offsets[1 + i]
        mats = []
        for k_in, n_out in phase:
            size = k_in * n_out * width
            mats.append(_unfrag(weights[pos:pos + size], k_in, n_out))
            pos += size
        assert pos == offsets[2 + i]
        phases.append(mats)
    return phases, weights[offsets[0]:offsets[1]]


def _product(a, w):
    """``a @ w`` as 3xTF32, w given as (hi, lo)."""
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = w
    return a_hi @ w_hi + a_hi @ w_lo + a_lo @ w_hi


def _f10(x, idx):
    """[x_p, x_q, x_p - x_q, |x_p - x_q|, 0 x 6] of every (point, slot)
    row, as the kernel computes it."""
    nbr = x[torch.arange(x.shape[0])[:, None, None], idx]      # [B, n, K, 3]
    xp = x[:, :, None, :].expand_as(nbr)
    d = xp - nbr
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])[..., None]
    f = torch.cat([xp, nbr, d, dist, torch.zeros_like(nbr).repeat(1, 1, 1, 2)],
                  dim=-1)
    return f.reshape(-1, 16)


def _emulate(weights, offsets, x, idx):
    """The kernel's logits [B, n, K, 32] from the pack."""
    (fe, *groups), bias = _phase_mats(weights, offsets)
    e_groups, (d0, d12, d3, tail) = groups[:4], groups[4:]
    lrelu = F.leaky_relu
    f10 = _f10(x, idx)
    a = f10
    for j, w in enumerate(fe):                      # phase G
        h = lrelu(_product(a, w) + bias[256 + 16 * j:272 + 16 * j], 0.05)
        a = torch.cat([a, h], dim=1)
    acc = torch.zeros(a.shape[0], 128)
    for i, (w_out, w0) in enumerate(e_groups):      # phases E0-E3
        e = _product(a, w_out) + bias[384 + 32 * i:416 + 32 * i]
        acc = acc + _product(e, w0)
    h1 = lrelu(_product(f10, d0[0]) + bias[0:64], 0.01)    # phase D0
    h2 = lrelu(_product(h1, d0[1]) + bias[64:128], 0.01)
    d_groups = [d0[2:], d12[:2], d12[2:], d3]
    for i, (w2, w0) in enumerate(d_groups):         # phases D0-D2
        d = _product(h2, w2) + bias[128 + 32 * i:160 + 32 * i]
        acc = acc + _product(d, w0)
    y = lrelu(acc + bias[512:640], 0.01)            # phase T
    y = lrelu(_product(y, tail[0]) + bias[640:704], 0.01)
    return (_product(y, tail[1]) + bias[704:736]).reshape(B, N, K, 32)


def _epilogue(logits, mode, r, nei):
    if mode == "logits":
        return logits
    w = torch.softmax(logits[..., :r], dim=2)
    if mode == "weights":
        return w
    return torch.einsum("bnkc,bnkr->bncr", nei, w)


def _plain64(case, mode, r):
    head64 = torch.utils._pytree.tree_map(lambda t: t.double(), case["head"])
    return t_interp.interp_head_plain(head64, case["x"].double(), case["idx"],
                                      r, mode, case["z"].double()).numpy()


@pytest.mark.parametrize("r", [1, 4])
def test_emulated_head_meets_the_exact_bounds(case, r):
    weights, offsets = t_interp._pack(case["head"])
    logits = _emulate(weights, offsets, case["x"], case["idx"])
    nei = torch.from_numpy(case["nei"])
    scale = float(np.abs(case["logits"]).max())
    # measured at r = 1 and 4: logits 1.3e-7 from JAX, weights 3.0e-8,
    # latents 1.2e-7; from the float64 plain version 1.3e-7, 2.3e-8 and
    # 1.4e-7, against a logits' scale of 0.18
    for mode, gate in GATES.items():
        got = _epilogue(logits, mode, r, nei).numpy()
        ref = _jax_ref(case, mode, r)
        assert got.shape == ref.shape
        err = float(np.abs(got - ref).max())
        err64 = float(np.abs(got - _plain64(case, mode, r)).max())
        print(f"{mode} r={r}: {err:.3e} from JAX (gate {gate}), {err64:.3e} "
              f"from float64 (logits' scale {scale:.3f})")
        assert err < gate, (mode, err)
        assert err64 <= 1e-5 * scale, (mode, err64)
    plain = t_interp.interp_head_plain(case["head"], case["x"], case["idx"],
                                       r, "logits")
    assert not torch.equal(logits, plain)          # the products did change


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def test_pack_lays_out_every_phase(case):
    """The biases in the kernel's order; each phase's B fragments are tf32
    values, hi is tf32(weight), hi + lo the weight to 2^-21 of it, and the
    k8 row order undoes to the [in, out] matrix the kernel takes."""
    weights, offsets = t_interp._pack(case["head"])
    assert all(o % 4 == 0 for o in offsets)
    assert offsets[-1] == weights.numel()
    mats, biases = t_interp._matrices(case["head"])
    np.testing.assert_array_equal(weights[:offsets[1]].numpy(),
                                  biases.numpy())
    phases, _ = _phase_mats(weights, offsets)
    for got, want in zip(phases, t_interp._phases(mats)):
        assert len(got) == len(want)
        for (hi, lo), m in zip(got, want):
            assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
            assert int((_bits(lo) & 0x1FFF).abs().max()) == 0
            np.testing.assert_array_equal(hi.numpy(), tf32_round(m).numpy())
            back = hi.double() + lo.double()
            assert bool(((back - m.double()).abs()
                         <= 2.0 ** -21 * m.double().abs()).all())
    # the EdgeConv rows over f10: W_self over x_p, W_nbr over x_q, zero over
    # x_p - x_q, |x_p - x_q| and the padding, then the growth rows
    lay = case["head"]["knn_context"]["feat_conv"]["convs"][3]["lin"]["w"]
    rows = mats["fe"][3]
    np.testing.assert_array_equal(rows[:3].numpy(),
                                  (lay[:3] - lay[6:9]).numpy())
    np.testing.assert_array_equal(rows[3:6].numpy(),
                                  (lay[3:6] + lay[6:9]).numpy())
    assert not bool(rows[6:16].any())
    np.testing.assert_array_equal(rows[16:].numpy(), lay[9:].numpy())


def test_pack_is_cached_per_parameters(case):
    """The pack is made once per parameters and made again after an
    in-place update of a head weight."""
    head = torch.utils._pytree.tree_map(lambda t: t.clone(), case["head"])
    first, offsets = t_interp._packed(head)
    assert t_interp._packed(head)[0] is first
    head["weight_unit"]["lin0"]["w"].mul_(1.5)
    again, _ = t_interp._packed(head)
    assert again is not first
    assert not torch.equal(again, first)
    np.testing.assert_array_equal(again.numpy(),
                                  t_interp._pack(head)[0].numpy())
    _build._PACKS.clear()
