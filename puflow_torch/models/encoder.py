"""Geometry-context encoders for the interpolation flow.

Counterpart of `puflow_tpu.models.encoder`. Every apply function returns
``(out, new_state)`` as the JAX functions do: with ``train=True`` BatchNorm
normalises with batch statistics and the new state carries the moved
running statistics; with ``train=False`` it uses the running statistics
and hands the state back. A layer whose ``bn`` / ``bn0`` / ``bn1`` key is
absent was folded by `models.fold_bn` and skips BN (inference only).
  * `feature_extract_apply` — densely-connected EdgeConv stack (LeakyReLU
    0.05) with a max-pool over the K neighbours;
  * the distance encoder, the k-NN context and the weight unit, which
    make the interpolation logits;
  * `interpolation_apply` — softmax over the K=8 neighbour slots of the
    first r of R_MAX=32 logits, then the latent blend (`ops.interp`);
  * `feat_merge_apply` — the 2-layer bottleneck that makes flow conditions.

Layout is channel-last; every 1x1 conv is a channel matmul (models/nn.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from puflow_torch.models.nn import (bn_apply, bn_init, channel_matmul,
                                    linear_apply, linear_init)
from puflow_torch.ops.knn import gather_points, knn_indices

_FEU_SLOPE = 0.05   # FeatureExtractUnit LeakyReLU slope
_MLP_SLOPE = 0.01   # torch default slope (DistanceEncoder / WeightEstimation)

INTERP_K = 8        # neighbours blended per new point
R_MAX = 32          # max supported upratio


# --------------------------------------------------------------------------
# FeatureExtractUnit: densely-connected EdgeConv
# --------------------------------------------------------------------------
def feature_extract_init(generator, idim: int, odim: int, growth_width: int,
                         device=None):
    if odim % growth_width:
        raise ValueError(f"odim {odim} is not a multiple of {growth_width}")
    edim = idim * 3
    convs, bn_states = [], []
    in_ch = edim
    for i in range(odim // growth_width):
        w = linear_init(generator, in_ch, growth_width, device=device)
        bn_p, bn_s = bn_init(growth_width, device=device)
        convs.append({"lin": w, "bn": bn_p})
        bn_states.append(bn_s)
        in_ch = edim + growth_width * (i + 1)
    params = {"convs": convs,
              "conv_out": linear_init(generator, in_ch, odim, device=device)}
    return params, {"convs": bn_states}


def derive_edge_feat(x: torch.Tensor, knn_idx: torch.Tensor) -> torch.Tensor:
    """x: [B, N, C], knn_idx: [B, N, K] -> [B, N, K, 3C]:
    [x_tiled, knn_feat, knn_feat - x_tiled], the edge feature that
    `feature_extract_apply` factorises onto its input."""
    knn_feat = gather_points(x, knn_idx)                    # [B, N, K, C]
    x_tiled = x[:, :, None, :].expand_as(knn_feat)
    return torch.cat([x_tiled, knn_feat, knn_feat - x_tiled], dim=-1)


def feature_extract_apply(params, state, x: torch.Tensor,
                          knn_idx: torch.Tensor, train: bool = False,
                          pooling: bool = True, group=None):
    """x: [B, N, C] -> (pooled [B, N, odim] or per-slot [B, N, K, odim],
    new state). ``state`` is None when the params are folded. ``group``
    (a `parallel.Group`) makes train-mode BN use the global batch's
    statistics (`models.nn.bn_apply`).

    The edge feature [x, x_nbr, x_nbr - x] of every layer factorises onto
    the block input: ``e @ W = x @ (W_0 - W_2) + x_nbr @ (W_1 + W_2)``. So
    the whole stack gathers once per block: ``x @ [W_nbr_0 | ...]`` is
    gathered and sliced per layer, as in the JAX package.
    """
    C = x.shape[-1]
    layers = list(params["convs"]) + [{"lin": params["conv_out"]}]
    w_selfs, w_nbrs, offsets = [], [], [0]
    for layer in layers:
        w = layer["lin"]["w"]
        w_selfs.append(w[:C] - w[2 * C:3 * C])
        w_nbrs.append(w[C:2 * C] + w[2 * C:3 * C])
        offsets.append(offsets[-1] + w.shape[1])
    p_self = channel_matmul(x, torch.cat(w_selfs, dim=1))
    p_nbr = gather_points(channel_matmul(x, torch.cat(w_nbrs, dim=1)),
                          knn_idx)                          # [B, N, K, sum]

    def edge_term(i):
        lo, hi = offsets[i], offsets[i + 1]
        return p_self[:, :, None, lo:hi] + p_nbr[..., lo:hi]

    h_cat = None
    new_bn = []
    for i, conv_p in enumerate(params["convs"]):
        h = edge_term(i)
        if h_cat is not None:
            h = h + channel_matmul(h_cat, conv_p["lin"]["w"][3 * C:])
        h = h + conv_p["lin"]["b"]
        bn_s = None if state is None else state["convs"][i]
        if "bn" in conv_p:
            h, bn_s = bn_apply(conv_p["bn"], bn_s, h, train, group)
        new_bn.append(bn_s)
        h = F.leaky_relu(h, _FEU_SLOPE)
        h_cat = h if h_cat is None else torch.cat([h_cat, h], dim=-1)

    f = edge_term(len(layers) - 1)
    f = f + channel_matmul(h_cat, params["conv_out"]["w"][3 * C:])
    f = f + params["conv_out"]["b"]                         # [B, N, K, odim]
    out = torch.amax(f, dim=2) if pooling else f
    return out, (None if state is None else {"convs": new_bn})


# --------------------------------------------------------------------------
# DistanceEncoder, KnnContextEncoder, WeightEstimationUnit
# --------------------------------------------------------------------------
def distance_encoder_init(generator, dim_in: int = 3, dim_out: int = 128,
                          device=None):
    c_in = dim_in * 3 + 1
    bn0_p, bn0_s = bn_init(64, device=device)
    bn1_p, bn1_s = bn_init(64, device=device)
    params = {
        "lin0": linear_init(generator, c_in, 64, device=device), "bn0": bn0_p,
        "lin1": linear_init(generator, 64, 64, device=device), "bn1": bn1_p,
        "lin2": linear_init(generator, 64, dim_out, device=device),
    }
    return params, {"bn0": bn0_s, "bn1": bn1_s}


def distance_feat(xyz: torch.Tensor, knn_idx: torch.Tensor) -> torch.Tensor:
    """[pt, neighbour, pt - neighbour, |pt - neighbour|] per slot:
    [B, N, K, 10] for 3-D points. The vector is point minus neighbour, the
    opposite sign to `derive_edge_feat`'s."""
    neighbours = gather_points(xyz, knn_idx)                # [B, N, K, 3]
    pt = xyz[:, :, None, :].expand_as(neighbours)
    vec = pt - neighbours
    dist = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True))
    return torch.cat([pt, neighbours, vec, dist], dim=-1)


def distance_encoder_apply(params, state, xyz: torch.Tensor,
                           knn_idx: torch.Tensor, train: bool = False,
                           group=None):
    """[pt, neighbour, pt - neighbour, |pt - neighbour|] per slot through a
    BN-MLP -> ([B, N, K, dim_out], new state)."""
    neighbours = gather_points(xyz, knn_idx)                # [B, N, K, 3]
    pt = xyz[:, :, None, :].expand_as(neighbours)
    vec = pt - neighbours
    dist = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True))
    f = torch.cat([pt, neighbours, vec, dist], dim=-1)
    return _mlp3_apply(params, state, f, train, group)


def _mlp3_apply(params, state, x: torch.Tensor, train: bool, group=None):
    """lin0 -> [bn0] -> LeakyReLU -> lin1 -> [bn1] -> LeakyReLU -> lin2,
    BN skipped where folded. Returns (out, new state)."""
    h = x
    new_state = None if state is None else dict(state)
    for i in range(2):
        h = linear_apply(params[f"lin{i}"], h)
        if f"bn{i}" in params:
            h, new_state[f"bn{i}"] = bn_apply(params[f"bn{i}"],
                                              state[f"bn{i}"], h, train,
                                              group)
        h = F.leaky_relu(h, _MLP_SLOPE)
    return linear_apply(params["lin2"], h), new_state


def knn_context_init(generator, pc_channel: int = 3, device=None):
    de_p, de_s = distance_encoder_init(generator, pc_channel, 128,
                                       device=device)
    fe_p, fe_s = feature_extract_init(generator, pc_channel, 128,
                                      growth_width=16, device=device)
    return ({"distance_encoder": de_p, "feat_conv": fe_p},
            {"distance_encoder": de_s, "feat_conv": fe_s})


def knn_context_apply(params, state, xyz: torch.Tensor,
                      knn_idx: torch.Tensor, train: bool = False,
                      group=None):
    """xyz: [B, N, 3]; knn_idx: [B, N, k] -> ([B, N, k, 256], new state).
    ``state`` is None when the params are folded."""
    de_s = fe_s = None
    if state is not None:
        de_s, fe_s = state["distance_encoder"], state["feat_conv"]
    dist, de_s = distance_encoder_apply(params["distance_encoder"], de_s,
                                        xyz, knn_idx, train, group)
    feat, fe_s = feature_extract_apply(params["feat_conv"], fe_s, xyz,
                                       knn_idx, train, pooling=False,
                                       group=group)
    new_state = (None if state is None
                 else {"distance_encoder": de_s, "feat_conv": fe_s})
    return torch.cat([dist, feat], dim=-1), new_state


def weight_unit_init(generator, feat_dim: int = 256, device=None):
    bn0_p, bn0_s = bn_init(128, device=device)
    bn1_p, bn1_s = bn_init(64, device=device)
    params = {
        "lin0": linear_init(generator, feat_dim, 128, device=device),
        "bn0": bn0_p,
        "lin1": linear_init(generator, 128, 64, device=device), "bn1": bn1_p,
        "lin2": linear_init(generator, 64, R_MAX, device=device),
    }
    return params, {"bn0": bn0_s, "bn1": bn1_s}


def weight_unit_apply(params, state, context: torch.Tensor,
                      train: bool = False, group=None):
    """context: [B, N, k, C] -> (logits [B, N, k, R_MAX], new state)."""
    return _mlp3_apply(params, state, context, train, group)


def interpolation_init(generator, pc_channel: int = 3, device=None):
    kc_p, kc_s = knn_context_init(generator, pc_channel, device=device)
    wu_p, wu_s = weight_unit_init(generator, 256, device=device)
    return ({"knn_context": kc_p, "weight_unit": wu_p},
            {"knn_context": kc_s, "weight_unit": wu_s})


def interpolation_apply(params, state, z: torch.Tensor, xyz: torch.Tensor,
                        upratio: int, train: bool = False,
                        knn_idx: torch.Tensor | None = None, group=None):
    """Blend each point's k-NN latents into `upratio` new latents.

    z: [B, N, C] latents; xyz: [B, N, 3] geometry -> ([B, N, C, upratio],
    new state). `knn_idx` may be a neighbour list with K >= INTERP_K
    sorted by ascending distance; its first INTERP_K columns are then the
    K=8 graph. Folded params at inference go through
    `ops.interp.interp_head` (the CUDA kernel for CUDA tensors); unfolded
    ones, and training, through its plain version with BN (on the global
    batch's statistics with a `parallel.Group`).
    """
    # ops.interp builds its plain version from this module's functions
    from puflow_torch.ops.interp import interp_head, interp_head_plain

    if not 1 <= upratio <= R_MAX:
        raise ValueError(f"upratio={upratio} out of range [1, {R_MAX}]: the "
                         f"weight head emits at most R_MAX={R_MAX} rows")
    if knn_idx is None:
        knn_idx = knn_indices(xyz, xyz, INTERP_K)
    elif knn_idx.shape[-1] < INTERP_K:
        raise ValueError(f"knn_idx has {knn_idx.shape[-1]} < {INTERP_K} "
                         "neighbours")
    knn_idx = knn_idx[..., :INTERP_K]
    if train:
        return interp_head_plain(params, xyz, knn_idx, upratio, "latents", z,
                                 state, train=True, group=group)
    if "bn0" not in params["weight_unit"]:
        return interp_head(params, xyz, knn_idx, upratio, "latents", z), state
    return interp_head_plain(params, xyz, knn_idx, upratio, "latents", z,
                             state), state


# --------------------------------------------------------------------------
# FeatMergeUnit
# --------------------------------------------------------------------------
def feat_merge_init(generator, idim: int, odim: int, device=None):
    return {"conv1": linear_init(generator, idim, idim // 2, device=device),
            "conv2": linear_init(generator, idim // 2, odim, bias=False,
                                 device=device)}


def feat_merge_apply(params, x: torch.Tensor) -> torch.Tensor:
    return linear_apply(params["conv2"],
                        F.relu(linear_apply(params["conv1"], x)))
