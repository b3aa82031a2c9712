"""Channel permutations: invertible 1x1 convolution and fixed index shuffles.

Counterpart of `puflow_tpu.flows.permutate`. Shuffle indices are static
tuples of ints (non-trainable), not tensors of the parameter tree.
"""

from __future__ import annotations

import numpy as np
import torch


def inv1x1_init(generator: torch.Generator, channel: int,
                device=None) -> dict:
    """Random-orthogonal (QR) weight."""
    w = torch.randn((channel, channel), generator=generator, device=device)
    q, _ = torch.linalg.qr(w)
    return {"W": q}


def inv1x1_forward(params: dict, x: torch.Tensor):
    """x: [B, N, C] -> (x @ W^T, slogdet(W) * N)."""
    w = params["W"]
    z = torch.einsum("ij,bnj->bni", w, x)
    return z, torch.linalg.slogdet(w)[1] * x.shape[1]


def inv1x1_inverse(params: dict, z: torch.Tensor):
    w = params["W"]
    x = torch.einsum("ij,bnj->bni", torch.linalg.inv(w), z)
    return x, -torch.linalg.slogdet(w)[1] * z.shape[1]


def reverse_indices(channel: int) -> tuple:
    """The 'reverse' permutation: [C-1, ..., 0]."""
    return tuple(range(channel - 1, -1, -1))


def random_indices(seed: int, channel: int) -> tuple:
    """The 'random' permutation: numpy's seeded shuffle of the reverse
    order, the same ints as the JAX package's."""
    idx = np.arange(channel - 1, -1, -1)
    np.random.RandomState(seed).shuffle(idx)
    return tuple(int(i) for i in idx)


def invert_indices(idx) -> tuple:
    """Inverse of a permutation given as a sequence of ints."""
    out = np.zeros(len(idx), dtype=np.int64)
    out[np.asarray(idx, dtype=np.int64)] = np.arange(len(idx))
    return tuple(int(v) for v in out)


def reverse_permute(x: torch.Tensor, idx: tuple) -> torch.Tensor:
    """Apply a static channel permutation on the last axis."""
    return x[..., list(idx)]
