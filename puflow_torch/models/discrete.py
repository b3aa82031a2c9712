"""PointInterpFlow (discrete): 6-block conditional Glow for point upsampling.

Counterpart of `puflow_tpu.models.discrete`, inference only. Per flow
block: ActNorm -> invertible 1x1 conv -> additive spatial coupling ->
reverse channel permute -> affine injector, conditioned on a densely
connected EdgeConv pyramid (`feat_extract`). Upsampling: points ->
latents through the forward flow f (`ops.flow.flow_f`), k-NN latent
interpolation (k=8, learned softmax weights), inverse flow g
(`ops.flow.flow_g`) on the interpolated latents. With BN-folded params
(`models.fold_bn`) every stage is a kernel wrapper: `ops.knn.knn_self`,
`ops.encoder.encoder_conditions`, `ops.interp.interp_head`, `flow_f` and
`ops.flow.flow_g_blend`.

Parameters are the JAX package's (params, state) trees, held as
`DiscreteModel`'s parameters and buffers; the functions take the trees.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from puflow_torch.flows.coupling import linear_a1d_init
from puflow_torch.flows.normalize import actnorm_init
from puflow_torch.flows.permutate import inv1x1_init
from puflow_torch.models.encoder import (
    INTERP_K,
    feat_merge_init,
    feature_extract_init,
    interpolation_apply,
    interpolation_init,
)
from puflow_torch.ops.encoder import (encoder_conditions,
                                      encoder_conditions_plain)
from puflow_torch.ops.flow import (
    flow_block_forward,
    flow_f,
    flow_g,
    flow_g_blend,
    flow_g_plain,
)
from puflow_torch.ops.interp import interp_head
from puflow_torch.ops.knn import knn_indices, knn_self
from puflow_torch.utils.device import resolve_device

NUM_BLOCKS = 6
NUM_NEIGHBORS = 16   # encoder k-NN
PC_CHANNEL = 3

FEAT_CHANNELS = [PC_CHANNEL, 32, 64, 128, 128, 128, 128]
GROWTH_WIDTHS = [8, 16, 32, 32, 32, 32]
COND_CHANNELS = [32, 64, 128, 128, 128, 128]
HDIM = 64


def flow_block_init(generator, cdim: int, is_even: bool,
                    idim: int = PC_CHANNEL, hdim: int = HDIM,
                    device=None) -> dict:
    tdim = 1 if is_even else 2  # spatial split size
    return {
        "actnorm": actnorm_init(idim, device=device),
        "inv1x1": inv1x1_init(generator, idim, device=device),
        "coupling1": {"bias_net": linear_a1d_init(
            generator, tdim, hdim, idim - tdim, cdim, device=device)},
        "coupling2": {
            "scale_net": linear_a1d_init(generator, cdim, hdim, idim,
                                         device=device),
            "bias_net": linear_a1d_init(generator, cdim, hdim, idim,
                                        device=device),
        },
    }


def init(generator: torch.Generator, device="cuda"):
    """Seeded (params, state): the same tree and shapes as the JAX `init`.

    The generator must live on ``device`` (a CUDA generator for CUDA);
    pass ``device="cpu"`` with a CPU generator to build on the host.
    """
    device = resolve_device(device)
    interp_p, interp_s = interpolation_init(generator, PC_CHANNEL,
                                            device=device)
    feat_p, feat_s, merge_p, flow_p = [], [], [], []
    for i in range(NUM_BLOCKS):
        fp, fs = feature_extract_init(generator, FEAT_CHANNELS[i],
                                      FEAT_CHANNELS[i + 1], GROWTH_WIDTHS[i],
                                      device=device)
        feat_p.append(fp)
        feat_s.append(fs)
        merge_p.append(feat_merge_init(generator, FEAT_CHANNELS[i + 1],
                                       COND_CHANNELS[i], device=device))
    for i in range(NUM_BLOCKS):
        flow_p.append(flow_block_init(generator, COND_CHANNELS[i],
                                      is_even=(i % 2 == 0), device=device))
    params = {"interp": interp_p, "feat_convs": feat_p,
              "merge_convs": merge_p, "flow_blocks": flow_p}
    state = {"interp": interp_s, "feat_convs": feat_s}
    return params, state


def feat_extract(params, state, xyz: torch.Tensor, knn_idx: torch.Tensor):
    """EdgeConv pyramid -> per-block conditions ``[B, N, cdim_i]``, as
    tensor ops (folded or unfolded params)."""
    return encoder_conditions_plain(params, xyz, knn_idx, state)


def f_transform(params, x: torch.Tensor, cs):
    """Points -> (latents, total log|det J| per cloud)."""
    log_det = torch.zeros((x.shape[0],), device=x.device)
    for i, (bp, c) in enumerate(zip(params["flow_blocks"], cs)):
        x, ld = flow_block_forward(bp, x, c, is_even=(i % 2 == 0))
        log_det = log_det + ld
    return x, log_det


def g_transform(params, z: torch.Tensor, cs, upratio: int) -> torch.Tensor:
    """Latents ``[B, N, C, r]`` -> points ``[B, N*r, C]``, point-major."""
    if z.shape[-1] != upratio:
        raise ValueError(f"latents carry {z.shape[-1]} samples, not {upratio}")
    return flow_g_plain(params["flow_blocks"], z, cs)


def is_folded(params) -> bool:
    """Whether BN is folded into the convs (`models.fold_bn`): no ``bn``
    in the first encoder conv and no ``bn0`` in the weight unit, the test
    of `puflow_tpu.models.discrete.forward`."""
    return ("bn" not in params["feat_convs"][0]["convs"][0]
            and "bn0" not in params["interp"]["weight_unit"])


def forward(params, state, xyz: torch.Tensor, upratio: int):
    """Inference pass ``[B, N, 3] -> ([B, N*r, 3], NaN, state)``.

    As the JAX package's inference branch: the forward flow runs without
    its log-density (returned as NaN). BN-folded params (`is_folded`) take
    the fused branch of `puflow_tpu.models.discrete.forward`, every stage a
    kernel wrapper; unfolded params run the encoder and the interpolation
    head as tensor ops, and both flows through their kernel wrappers.
    """
    if is_folded(params):
        xyz = xyz.contiguous()
        knn_idx = knn_self(xyz, NUM_NEIGHBORS)          # ascending, self first
        idx8 = knn_idx[..., :INTERP_K]                  # K=16 sorted -> K=8
        cs = encoder_conditions(params, xyz, knn_idx)
        ws = interp_head(params["interp"], xyz, idx8, upratio, "weights")
        z = flow_f(params["flow_blocks"], xyz, cs)
        x = flow_g_blend(params["flow_blocks"], z, ws, idx8, cs)
        return x, torch.tensor(float("nan")), state
    knn_idx = knn_indices(xyz, xyz, NUM_NEIGHBORS)
    cs = feat_extract(params, state, xyz, knn_idx)
    z = flow_f(params["flow_blocks"], xyz.contiguous(), cs)
    # K=16 sorted -> its first 8 columns ARE the K=8 graph
    fz = interpolation_apply(params["interp"], state["interp"], z, xyz,
                             upratio, knn_idx=knn_idx)
    x = flow_g(params["flow_blocks"], fz.contiguous(), cs)
    return x, torch.tensor(float("nan")), state


def sample(params, state, sparse: torch.Tensor,
           upratio: int = 4) -> torch.Tensor:
    """Inference entry: the dense cloud only."""
    dense, _, _ = forward(params, state, sparse, upratio)
    return dense


# --------------------------------------------------------------------------
# The trees as an nn.Module
# --------------------------------------------------------------------------
def _tree_module(tree, buffers: bool) -> nn.Module:
    """dict -> Module, list -> ModuleList, tensor -> parameter or buffer."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList(_tree_module(t, buffers) for t in tree)
    m = nn.Module()
    for key, val in tree.items():
        if isinstance(val, (dict, list, tuple)):
            m.add_module(key, _tree_module(val, buffers))
        elif buffers:
            m.register_buffer(key, val)
        else:
            m.register_parameter(key, nn.Parameter(val, requires_grad=False))
    return m


def _module_tree(m: nn.Module):
    if isinstance(m, nn.ModuleList):
        return [_module_tree(c) for c in m]
    tree = {k: v for k, v in m.named_parameters(recurse=False)}
    tree.update(m.named_buffers(recurse=False))
    tree.update((k, _module_tree(c)) for k, c in m.named_children())
    return tree


class DiscreteModel(nn.Module):
    """The discrete model's (params, state) trees as one module.

    Weights are parameters (``params.flow_blocks.0.actnorm.logs``, the
    `.npz` checkpoint keys with dots), BatchNorm running statistics are
    buffers (``state....``), so ``.to(device)`` and ``state_dict()`` work.
    Calling the module runs `sample`.
    """

    def __init__(self, params, state):
        super().__init__()
        self.params = _tree_module(params, buffers=False)
        self.state = _tree_module(state, buffers=True)

    def trees(self):
        """The (params, state) trees of tensors the functions take."""
        return _module_tree(self.params), _module_tree(self.state)

    @torch.no_grad()
    def forward(self, sparse: torch.Tensor, upratio: int = 4) -> torch.Tensor:
        params, state = self.trees()
        return sample(params, state, sparse, upratio)


def _leaves(tree, prefix: str):
    """(path, array) of every leaf of a nested dict/list tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        path = f"{prefix}/{key}"
        if isinstance(val, (dict, list, tuple)):
            yield from _leaves(val, path)
        else:
            yield path, val


def perturb_init(params, state, seed: int):
    """Seeded noise on numpy (params, state) trees, in place; returns them.

    Seeded init leaves every flow block close to the identity: the last
    layer of each coupling MLP is zero, ActNorm is zero and BatchNorm is
    the identity, so a comparison on raw init would check little beyond
    inv1x1. This moves those parameters with numpy noise drawn in sorted
    key order, so the same seed gives the same model whichever package
    made the trees.
    """
    rng = np.random.RandomState(seed)
    leaves = dict(_leaves(params, "params"))
    leaves.update(_leaves(state, "state"))
    for path in sorted(leaves):
        a = leaves[path]
        parent, leaf = path.rsplit("/", 2)[-2:]
        is_bn = parent.startswith("bn")
        if leaf == "var":
            a[...] = rng.uniform(0.5, 1.5, a.shape)
        elif is_bn and leaf == "scale":
            a[...] = rng.uniform(0.8, 1.2, a.shape)
        elif leaf == "mean" or (is_bn and leaf == "bias"):
            a[...] = rng.normal(0.0, 0.1, a.shape)
        elif parent == "actnorm":
            a[...] = rng.normal(0.0, 0.1, a.shape)
        elif leaf == "w2":
            a[...] = rng.normal(0.0, 0.5, a.shape)
        elif leaf == "b2":
            a[...] = rng.normal(0.0, 0.2, a.shape)
    return params, state
