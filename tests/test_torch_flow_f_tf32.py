"""The forward-flow kernel's 3xTF32 arithmetic, checked on the CPU.

`csrc/flow_f.cu` takes every product of flow f's coupling and injector
MLPs on the tensor cores as 3xTF32 (`csrc/mma_tf32.cuh`). Here `_emulate_f`
runs that arithmetic in torch, reading each block's weights from the
packing the kernel reads (`ops.flow._pack`, forward) at the kernel's
offsets (tests/torch_flow_cases.py), with the kernel's order of steps:
the three first layers on the block's condition, the injector's scale
and bias nets, ActNorm and inv1x1 as f32 FMAs, the coupling's first layer
as the condition's projection plus the h1 columns in f32, the 64 x 64
layers pre-split as packed, the other weights split as read, the
subtraction, the reverse and the injector's (x - b) * exp(-s) in f32.
The result is held to JAX's interpret-mode `flow_f_pallas` (its products
pinned to the exact 3-pass split) and to `discrete.f_transform` at atol
1e-5 * max(1, max|ref|), the gate tests/test_torch_flow_kernels.py holds
the plain f to. The kernel itself is held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Parameters: the full-width JAX `discrete.init`, `perturb_init`; 2 patches
of 64 points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from puflow_torch.ops import flow as t_flow
from puflow_tpu.ops.pallas import flow_pallas
from torch_flow_cases import (B, N, HEAD, W0H, block_nets, check,
                              check_block_layout, coupling_net,
                              injector_nets, make_case)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def case():
    return make_case()


def _emulate_f(weights, woff, cs, x):
    """The kernel's arithmetic on the rows ``x`` [P, 3], the weights read
    from the pack."""
    z = x.clone()
    for b in range(len(cs)):
        w = weights[woff[b]:woff[b + 1]]
        c = cs[b].reshape(-1, cs[b].shape[-1])
        kp = 8 * t_flow.k_chunks(c.shape[1])
        split = 1 if b % 2 == 0 else 2
        m = block_nets(w, kp)
        cp = F.pad(c, (0, kp - c.shape[1]))
        sc, bi = injector_nets(m, w, cp)
        head = w[HEAD:W0H]
        v = torch.addcmul(head[3:6], z, head[:3])            # ActNorm
        v = v @ head[6:15].reshape(3, 3).T                     # inv1x1
        sub = coupling_net(m, w, cp, v, split)
        v = torch.cat([v[:, :split], v[:, split:] - sub], 1)
        z = (v.flip(-1) - bi) * torch.exp(-sc)
    return z


def test_emulated_flow_f_meets_the_exact_bound(case):
    weights, woff = t_flow._pack(case["blocks"], inverse=False)
    x = torch.from_numpy(case["x"])
    got = _emulate_f(weights, woff, case["t_cs"], x.reshape(-1, 3))
    got = got.reshape(B, N, 3).numpy()
    plain = t_flow.flow_f_plain(case["blocks"], x, case["t_cs"]).numpy()
    assert not np.array_equal(got, plain)   # the products did change
    kernel = np.asarray(flow_pallas.flow_f_pallas(
        case["jp"]["flow_blocks"], jnp.asarray(case["x"]), case["cs"], True))
    z = np.asarray(case["z"])
    # the perturbed flows do work, at the latent scale of real conditions
    assert np.abs(z - case["x"]).max() > 0.1
    check(got, {"kernel": kernel, "xla": z}, "flow f")


def test_pack_f_lays_out_every_block(case):
    """Per block: the head (exp(logs), the ActNorm bias, W) as the kernel
    reads it, and every matrix of the block rebuilt from the pack
    (`check_block_layout`)."""
    weights, woff = t_flow._pack(case["blocks"], inverse=False)
    assert all(o % 4 == 0 for o in woff)
    assert woff[-1] == weights.numel()
    for i, bp in enumerate(case["blocks"]):
        w = weights[woff[i]:woff[i + 1]]
        an = bp["actnorm"]
        np.testing.assert_array_equal(
            w[:3].numpy(), torch.exp(an["logs"]).reshape(-1).numpy())
        np.testing.assert_array_equal(w[3:6].numpy(),
                                      an["bias"].reshape(-1).numpy())
        np.testing.assert_array_equal(
            w[6:15].numpy(), bp["inv1x1"]["W"].reshape(-1).numpy())
        assert float(w[15]) == 0.0
        check_block_layout(w, bp, 1 if i % 2 == 0 else 2)
