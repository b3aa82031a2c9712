"""Fold eval-mode BatchNorm into the preceding 1x1 convs for inference.

Counterpart of `puflow_tpu.models.fold_bn`. Eval BN is a per-channel
affine map, so composed with the linear layer before it it is another
linear layer:

    w' = w * g,   b' = (b - mean) * g + bias,   g = scale / sqrt(var + eps)

The folded tree drops the ``bn`` / ``bn0`` / ``bn1`` keys; the apply
functions of `models.encoder` skip BN where its key is absent, and
`discrete.forward` takes the folded inference branch (the hand-written
k-NN, encoder, interpolation-head and blend kernels) when it sees them
gone. Inference only: training keeps the unfolded parameters.
"""

from __future__ import annotations

import torch

from puflow_torch.models.nn import BN_EPS


def _fold_linear(lin: dict, bn_p: dict, bn_s: dict) -> dict:
    g = bn_p["scale"] * torch.rsqrt(bn_s["var"] + BN_EPS)
    b = lin.get("b", 0.0)
    return {"w": lin["w"] * g[None, :],
            "b": (b - bn_s["mean"]) * g + bn_p["bias"]}


def _fold_feature_extract(p: dict, s: dict) -> dict:
    convs = [{"lin": _fold_linear(conv["lin"], conv["bn"], bn_s)}
             for conv, bn_s in zip(p["convs"], s["convs"])]
    return {"convs": convs, "conv_out": p["conv_out"]}


def _fold_mlp3(p: dict, s: dict) -> dict:
    return {"lin0": _fold_linear(p["lin0"], p["bn0"], s["bn0"]),
            "lin1": _fold_linear(p["lin1"], p["bn1"], s["bn1"]),
            "lin2": p["lin2"]}


def fold_bn_inference(params: dict, state: dict) -> dict:
    """(params, BN state) -> folded params for inference; the same tree
    as `puflow_tpu.models.fold_bn.fold_bn_inference`."""
    interp_p, interp_s = params["interp"], state["interp"]
    kc_p, kc_s = interp_p["knn_context"], interp_s["knn_context"]
    return {
        "interp": {
            "knn_context": {
                "distance_encoder": _fold_mlp3(kc_p["distance_encoder"],
                                               kc_s["distance_encoder"]),
                "feat_conv": _fold_feature_extract(kc_p["feat_conv"],
                                                   kc_s["feat_conv"]),
            },
            "weight_unit": _fold_mlp3(interp_p["weight_unit"],
                                      interp_s["weight_unit"]),
        },
        "feat_convs": [_fold_feature_extract(fp, fs) for fp, fs in
                       zip(params["feat_convs"], state["feat_convs"])],
        "merge_convs": params["merge_convs"],
        "flow_blocks": params["flow_blocks"],
    }


def empty_bn_state(state):
    """A state tree of the same structure with empty leaves: the folded
    forward reads no BN statistics."""
    if isinstance(state, dict):
        return {k: empty_bn_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [empty_bn_state(v) for v in state]
    return torch.zeros((0,), device=state.device)
