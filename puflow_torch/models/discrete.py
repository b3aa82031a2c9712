"""PointInterpFlow (discrete): 6-block conditional Glow for point upsampling.

Counterpart of `puflow_tpu.models.discrete`. Per flow block: ActNorm ->
invertible 1x1 conv -> additive spatial coupling -> reverse channel
permute -> affine injector, conditioned on a densely connected EdgeConv
pyramid (`feat_extract`). Upsampling: points -> latents through the
forward flow f, k-NN latent interpolation (k=8, learned softmax weights),
inverse flow g on the interpolated latents.

Inference (`sample`, `forward(..., fast_f=True)`) runs f and g through
their kernel wrappers (`ops.flow`); with BN-folded params
(`models.fold_bn`) every stage is a kernel wrapper: `ops.knn.knn_self`,
`ops.encoder.encoder_conditions`, `ops.interp.interp_head`, `flow_f` and
`ops.flow.flow_g_blend`. Training (`forward(..., train=True)`) is plain
tensor ops with autograd, as the JAX package's training branch is XLA:
batch-statistics BN, f with its log-determinant (`log_prob`), the plain
interpolation head and the plain inverse flow.

Parameters are the JAX package's (params, state) trees, held as
`DiscreteModel`'s parameters and buffers; the functions take the trees.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from puflow_torch.flows.coupling import linear_a1d_init
from puflow_torch.flows.normalize import actnorm_init, actnorm_init_from_data
from puflow_torch.flows.permutate import inv1x1_init
from puflow_torch.flows.prior import standard_gaussian_logp
from puflow_torch.models.encoder import (
    INTERP_K,
    feat_merge_apply,
    feat_merge_init,
    feature_extract_apply,
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
from puflow_torch.parallel.mesh import all_reduce_sum, is_distributed
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


def encoder_is_folded(params) -> bool:
    """Whether BN is folded into the encoder's convs (`models.fold_bn`)."""
    return "bn" not in params["feat_convs"][0]["convs"][0]


def feat_extract(params, state, xyz: torch.Tensor, knn_idx: torch.Tensor,
                 train: bool = False, group=None):
    """EdgeConv pyramid -> (per-block conditions ``[B, N, cdim_i]``, new
    encoder BN state; ``state`` may be None when the params are folded).

    Folded params at inference go through `ops.encoder.encoder_conditions`
    (the CUDA kernel for CUDA tensors, its plain version for CPU tensors),
    the dispatch of `puflow_tpu.models.discrete.feat_extract` without its
    size gate; unfolded params, and training, are tensor ops with BN
    (train-mode BN on the global batch's statistics with a
    `parallel.Group`).
    """
    feat_s = None if state is None else state["feat_convs"]
    if not train:
        if encoder_is_folded(params):
            return encoder_conditions(params, xyz.contiguous(),
                                      knn_idx), feat_s
        return encoder_conditions_plain(params, xyz, knn_idx, state), feat_s
    cs, new_fs = [], []
    c = xyz
    for fp, fs, mp in zip(params["feat_convs"], feat_s,
                          params["merge_convs"]):
        c, fs = feature_extract_apply(fp, fs, c, knn_idx, train=True,
                                      group=group)
        new_fs.append(fs)
        cs.append(feat_merge_apply(mp, c))
    return cs, new_fs


def f_transform(params, x: torch.Tensor, cs):
    """Points -> (latents, total log|det J| per cloud)."""
    log_det = torch.zeros((x.shape[0],), device=x.device)
    for i, (bp, c) in enumerate(zip(params["flow_blocks"], cs)):
        x, ld = flow_block_forward(bp, x, c, is_even=(i % 2 == 0))
        log_det = log_det + ld
    return x, log_det


def g_transform(params, z: torch.Tensor, cs, upratio: int,
                fast: bool = False) -> torch.Tensor:
    """Latents ``[B, N, C, r]`` -> points ``[B, N*r, C]``, point-major.
    ``fast=True`` (inference) goes through the `ops.flow.flow_g` kernel
    wrapper, which has no backward; training keeps the plain version."""
    if z.shape[-1] != upratio:
        raise ValueError(f"latents carry {z.shape[-1]} samples, not {upratio}")
    if fast:
        return flow_g(params["flow_blocks"], z.contiguous(), cs)
    return flow_g_plain(params["flow_blocks"], z, cs)


def log_prob(params, x: torch.Tensor, cs, group=None):
    """(z, scalar NLL objective): ``-mean(log p(z) + log|det J|)``; with a
    `parallel.Group` of more than one rank, ``x`` is this rank's shard and
    the mean is the global batch's, through the differentiable all-reduce
    (every rank gets the same value)."""
    z, log_det = f_transform(params, x, cs)
    logp = standard_gaussian_logp(z)
    if is_distributed(group):
        total = all_reduce_sum(torch.sum(logp + log_det))
        return z, -total / (x.shape[0] * group.world_size)
    return z, -torch.mean(logp + log_det)


def is_folded(params) -> bool:
    """Whether BN is folded into the convs (`models.fold_bn`): no ``bn``
    in the first encoder conv and no ``bn0`` in the weight unit, the test
    of `puflow_tpu.models.discrete.forward`."""
    return (encoder_is_folded(params)
            and "bn0" not in params["interp"]["weight_unit"])


def forward(params, state, xyz: torch.Tensor, upratio: int,
            train: bool = False, fast_f: bool = False, group=None):
    """Full upsampling pass ``[B, N, 3] -> ([B, N*r, 3], scalar NLL,
    new state)``.

    ``train=True``: BN on batch statistics, the NLL through `log_prob`,
    the plain interpolation head and inverse flow, all differentiable; the
    new state carries the moved BN running statistics.
    ``fast_f=True`` (inference only, what `sample` passes): the forward
    flow runs without its log-density, returned as NaN. BN-folded params
    then take the fused branch of `puflow_tpu.models.discrete.forward`,
    every stage a kernel wrapper; unfolded params run the encoder and the
    interpolation head as tensor ops, and both flows through their kernel
    wrappers. Inference without ``fast_f`` (validation) computes the NLL
    with the plain f.
    ``group`` (a `parallel.Group`, training only): ``xyz`` is this rank's
    shard of the global batch; train-mode BN takes the global batch's
    statistics and the NLL is the global batch's mean, as the JAX
    package's forward computes them under a sharded jit.
    """
    if fast_f and not train and is_folded(params):
        xyz = xyz.contiguous()
        knn_idx = knn_self(xyz, NUM_NEIGHBORS)          # ascending, self first
        idx8 = knn_idx[..., :INTERP_K]                  # K=16 sorted -> K=8
        cs = encoder_conditions(params, xyz, knn_idx)
        ws = interp_head(params["interp"], xyz, idx8, upratio, "weights")
        z = flow_f(params["flow_blocks"], xyz, cs)
        x = flow_g_blend(params["flow_blocks"], z, ws, idx8, cs)
        return x, torch.full((), float("nan"), device=xyz.device), state
    knn_idx = knn_indices(xyz, xyz, NUM_NEIGHBORS)
    cs, feat_s = feat_extract(params, state, xyz, knn_idx, train, group)
    if fast_f and not train:
        z = flow_f(params["flow_blocks"], xyz.contiguous(), cs)
        logp_x = torch.full((), float("nan"), device=xyz.device)
    else:
        z, logp_x = log_prob(params, xyz, cs, group)
    # K=16 sorted -> its first 8 columns ARE the K=8 graph
    fz, interp_s = interpolation_apply(
        params["interp"], None if state is None else state["interp"], z,
        xyz, upratio, train, knn_idx=knn_idx, group=group)
    x = g_transform(params, fz, cs, upratio, fast=not train)
    new_state = None if state is None else {"interp": interp_s,
                                            "feat_convs": feat_s}
    return x, logp_x, new_state


def sample(params, state, sparse: torch.Tensor,
           upratio: int = 4) -> torch.Tensor:
    """Inference entry: the dense cloud only."""
    dense, _, _ = forward(params, state, sparse, upratio, fast_f=True)
    return dense


@torch.no_grad()
def actnorm_warmup(params, state, xyz: torch.Tensor):
    """Data-dependent ActNorm init from one representative batch: returns
    params whose every block's ActNorm is set from the activations that
    the already initialised earlier blocks produce, as the reference's
    first forward does. Run once before training."""
    knn_idx = knn_indices(xyz, xyz, NUM_NEIGHBORS)
    cs, _ = feat_extract(params, state, xyz, knn_idx)
    new_blocks = []
    x = xyz
    for i, (bp, c) in enumerate(zip(params["flow_blocks"], cs)):
        bp = dict(bp, actnorm=actnorm_init_from_data(x))
        x, _ = flow_block_forward(bp, x, c, is_even=(i % 2 == 0))
        new_blocks.append(bp)
    return dict(params, flow_blocks=new_blocks)


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
    def forward(self, sparse: torch.Tensor, upratio: int = 4,
                group=None) -> torch.Tensor:
        """`sample` of the patches. ``group`` (a `parallel.Group`, as
        `ContinuousModel` takes one) changes nothing: every patch is
        sampled alone, BN on its running statistics."""
        params, state = self.trees()
        return sample(params, state, sparse, upratio)


def _leaves(tree, prefix: str = ""):
    """(path, leaf) of every leaf of a nested dict/list tree, with the
    `.npz` key paths (``prefix/flow_blocks/0/...``)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        path = f"{prefix}/{key}" if prefix else str(key)
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

    On the CNF family's trees (`models.continuous`) it also moves the end
    times apart and gives the layers' time rows (``hyper_gate`` /
    ``hyper_bias`` ``w[0]``) a large scale: a seeded field barely depends
    on t, and every solve would take the controller's minimum of three
    steps with none rejected.
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
        elif parent in ("hyper_gate", "hyper_bias") and leaf == "w":
            # a tenth of the scale on the output layer, whose time row
            # translates the whole state: it stays of order 1
            a[0] = rng.normal(0.0, 20.0 if a.shape[1] > PC_CHANNEL else 2.0,
                              a.shape[1])
        elif leaf == "sqrt_end_time":
            a[...] = rng.uniform(0.5, 0.7)
    return params, state
