"""Shared pieces of the flow kernels' CPU emulation tests.

`csrc/flow_f.cu` and `csrc/flow_g.cu` take every product of the injector
and coupling MLPs on the tensor cores as 3xTF32 (hi = tf32(x), lo =
tf32(x - hi), a product is hi*hi + hi*lo + lo*hi with f32 accumulation;
`csrc/mma_tf32.cuh`), from one layout of a block's weights
(`ops.flow._pack`; its 16-float head differs by direction). Here: the
case both tests run (the full-width JAX `discrete.init`, `perturb_init`,
2 patches of 64 points), a block's matrices read back from the pack as
the kernels take them, the 3xTF32 product, the layout check and the
bound, atol 1e-5 * max(1, max|ref|), the JAX package's own 3-pass g bound
(tests/test_fused_kernels.py:263-264).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.models import discrete as t_discrete
from puflow_torch.ops import flow as t_flow
from puflow_torch.ops.encoder import split_tf32, tf32_round
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.ops.knn import knn_indices

B, N = 2, 64
# offsets of a block's weights (csrc/flow_common.cuh, kW0h ... kFrags)
HEAD, W0H, CB1, SB1, BB1, CB2, SB2, BB2, FRAGS = (0, 16, 144, 208, 272, 336,
                                                  344, 352, 360)


def make_case():
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


def unfrag(flat, k_in, n_out, presplit):
    """B fragments -> (hi, lo) of the [k_in, n_out] matrix, as the kernels
    take them: stored (pre-split) or split as read (f32 pairs)."""
    f = flat.reshape(k_in // 8, n_out // 8, 8, 4, 4 if presplit else 2)

    def undo(x):
        return x.permute(0, 3, 4, 1, 2).reshape(k_in, n_out)

    if presplit:
        return undo(f[..., :2]), undo(f[..., 2:])
    return split_tf32(undo(f))


def product(a, w):
    """``a @ w`` as 3xTF32, w given as (hi, lo)."""
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = w
    return a_hi @ w_hi + a_hi @ w_lo + a_lo @ w_hi


def lrelu(x):
    return F.leaky_relu(x, 0.01)


def block_nets(w, kp):
    """A packed block's matrices as (hi, lo), read at the kernels'
    offsets: s_w0, b_w0, c_w0 ([kp, 64]), s_w2, b_w2, c_w2 ([64, 8]), s_w1,
    b_w1, c_w1 ([64, 64])."""
    off, out = FRAGS, []
    for k_in, n_out, presplit in [(kp, 64, False)] * 3 + [(64, 8, False)] * 3 \
            + [(64, 64, True)] * 3:
        size = k_in * n_out * (2 if presplit else 1)
        out.append(unfrag(w[off:off + size], k_in, n_out, presplit))
        off += size
    assert off == w.numel()
    return dict(zip(("s_w0", "b_w0", "c_w0", "s_w2", "b_w2", "c_w2", "s_w1",
                     "b_w1", "c_w1"), out))


def injector_nets(m, w, cp):
    """The injector's scale and bias nets on the padded conditions cp, the
    kernels' way: [rows, 3] each."""
    out = []
    for net, b1, b2 in (("s", w[SB1:BB1], w[SB2:BB2]),
                        ("b", w[BB1:CB2], w[BB2:FRAGS])):
        h = lrelu(product(cp, m[f"{net}_w0"]))
        h = lrelu(product(h, m[f"{net}_w1"]) + b1)
        out.append((product(h, m[f"{net}_w2"]) + b2)[:, :3])
    return out


def coupling_net(m, w, cp, v, split):
    """The coupling's MLP on [h1, c]: the condition's projection as a
    3xTF32 product plus the h1 columns v[:, :split] in f32; [rows, 3 -
    split]."""
    h = product(cp, m["c_w0"])
    w0h = w[W0H:CB1].reshape(2, 64)
    for j in range(split):
        h = torch.addcmul(h, v[:, j:j + 1], w0h[j])
    h = lrelu(product(lrelu(h), m["c_w1"]) + w[CB1:SB1])
    return (product(h, m["c_w2"]) + w[CB2:SB2])[:, :3 - split]


def check(got, refs, label):
    for name, ref in refs.items():
        err = float(np.abs(got - ref).max())
        tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
        print(f"{label} vs {name}: {err:.3e} (tol {tol:.3e}, "
              f"{err / tol:.1%} of it)")
        assert got.shape == ref.shape
        assert err <= tol, (label, name, err, tol)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def check_block_layout(w, bp, split):
    """A packed block past its head: c_w0's h1 rows and the biases as the
    kernels read them; every f32 fragment run undoes to its zero-padded
    weight matrix exactly; the 64 x 64 layers' pre-split fragments are
    tf32 values, hi is tf32(weight) and hi + lo the weight to 2^-21 of
    it."""
    c1 = bp["coupling1"]["bias_net"]
    sn, bn = bp["coupling2"]["scale_net"], bp["coupling2"]["bias_net"]
    kp = 8 * t_flow.k_chunks(sn["w0"].shape[0])
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
