"""Convert reference PyTorch checkpoints to the port's numpy parameter trees.

The port's copy of `puflow_tpu.convert.torch_ckpt`. Reads the raw
``state_dict`` files the reference ships in ``pretrain/`` (saved at
reference `modules/discrete/train_pu1k.py:172-176`) and emits the numpy
``(params, state)`` trees in the JAX package's keys, which
`puflow_torch.checkpoint.from_numpy_tree` puts on a device.

Contract honoured (see SURVEY.md §5.4):
  * torch ``nn.Linear.weight`` is ``[out, in]`` -> transposed to ``[in, out]``.
  * torch ``Conv2d(k=[1,1]).weight`` is ``[out, in, 1, 1]`` -> ``[in, out]``.
  * BatchNorm ``running_mean/var`` -> the `state` tree;
    ``num_batches_tracked`` is dropped (unused by eval-mode BN).
  * ActNorm ``logs/bias`` keep their ``(1, 1, 3)`` shape.
  * inv1x1 ``W`` kept as-is; reverse-permutation index buffers are validated
    against the static reverse permutation and then dropped.
  * loading a checkpoint implies ActNorm is initialised (the reference calls
    ``set_to_initialized_state()`` after load, `interpflow.py:323-325`);
    params are plain arrays here so nothing extra is needed.

Files are read with ``torch.load(..., weights_only=True)``: tensors only,
no pickled code runs.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_numpy(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def load_torch_state_dict(path: str) -> dict:
    """Load a torch state_dict into {key: np.ndarray}."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _to_numpy(v) if v.dtype.is_floating_point else
            np.asarray(v.cpu().numpy()) for k, v in sd.items()}


def _linear(sd: dict, prefix: str, bias: bool = True) -> dict:
    p = {"w": sd[f"{prefix}.weight"].T.copy()}
    if bias:
        p["b"] = sd[f"{prefix}.bias"].copy()
    return p


def _conv1x1(sd: dict, prefix: str) -> dict:
    w = sd[f"{prefix}.weight"]  # [out, in, 1, 1]
    return {"w": w[:, :, 0, 0].T.copy(), "b": sd[f"{prefix}.bias"].copy()}


def _bn(sd: dict, prefix: str):
    params = {"scale": sd[f"{prefix}.weight"].copy(),
              "bias": sd[f"{prefix}.bias"].copy()}
    state = {"mean": sd[f"{prefix}.running_mean"].copy(),
             "var": sd[f"{prefix}.running_var"].copy()}
    return params, state


def _linear_a1d(sd: dict, prefix: str) -> dict:
    """LinearA1D: Sequential[Linear(no bias), LReLU, Linear, LReLU, Linear]."""
    return {
        "w0": sd[f"{prefix}.layers.0.weight"].T.copy(),
        "w1": sd[f"{prefix}.layers.2.weight"].T.copy(),
        "b1": sd[f"{prefix}.layers.2.bias"].copy(),
        "w2": sd[f"{prefix}.layers.4.weight"].T.copy(),
        "b2": sd[f"{prefix}.layers.4.bias"].copy(),
    }


def _feature_extract(sd: dict, prefix: str, num_conv: int):
    """FeatureExtractUnit: convs.{i}.{0=conv,1=bn} + conv_out."""
    convs, bn_states = [], []
    for i in range(num_conv):
        lin = _conv1x1(sd, f"{prefix}.convs.{i}.0")
        bn_p, bn_s = _bn(sd, f"{prefix}.convs.{i}.1")
        convs.append({"lin": lin, "bn": bn_p})
        bn_states.append(bn_s)
    params = {"convs": convs, "conv_out": _conv1x1(sd, f"{prefix}.conv_out")}
    return params, {"convs": bn_states}


def _mlp3(sd: dict, prefix: str):
    """Conv-BN-LReLU x2 + Conv head (DistanceEncoder / WeightEstimationUnit).

    torch Sequential indices: 0 conv, 1 bn, 3 conv, 4 bn, 6 conv.
    """
    bn0_p, bn0_s = _bn(sd, f"{prefix}.1")
    bn1_p, bn1_s = _bn(sd, f"{prefix}.4")
    params = {
        "lin0": _conv1x1(sd, f"{prefix}.0"), "bn0": bn0_p,
        "lin1": _conv1x1(sd, f"{prefix}.3"), "bn1": bn1_p,
        "lin2": _conv1x1(sd, f"{prefix}.6"),
    }
    return params, {"bn0": bn0_s, "bn1": bn1_s}


def convert_discrete(sd: dict, num_blocks: int = 6):
    """Reference `PointInterpFlow` state_dict -> (params, state) pytrees."""
    if "flow_blocks.0.actnorm.logs" not in sd:
        kind = ("continuous (CNF)" if "flow_blocks.0.cnf.sqrt_end_time" in sd
                else "unknown")
        raise ValueError(
            f"checkpoint is not a discrete PointInterpFlow state_dict "
            f"(looks like: {kind}); pass model='cnf' to load CNF weights")
    interp_p, interp_s, feat_p, feat_s, merge_p = _encoder_trees(
        sd, num_blocks)

    # --- flow blocks ---
    flow_p = []
    for i in range(num_blocks):
        pre = f"flow_blocks.{i}"
        # sanity: the shipped 'reverse' permutation must be [2, 1, 0]
        direct = sd.get(f"{pre}.permutate2.permutater.direct_idx")
        if direct is not None and list(direct) != [2, 1, 0]:
            raise ValueError(
                f"unexpected permutation {direct} in block {i}; the static "
                "reverse permutation assumption does not hold")
        flow_p.append({
            "actnorm": {
                "logs": sd[f"{pre}.actnorm.logs"].copy(),
                "bias": sd[f"{pre}.actnorm.bias"].copy(),
            },
            "inv1x1": {"W": sd[f"{pre}.permutate1.permutater.W"].copy()},
            "coupling1": {
                "bias_net": _linear_a1d(sd, f"{pre}.coupling1.bias_net")
            },
            "coupling2": {
                "scale_net": _linear_a1d(sd, f"{pre}.coupling2.scale_net"),
                "bias_net": _linear_a1d(sd, f"{pre}.coupling2.bias_net"),
            },
        })

    params = {
        "interp": interp_p,
        "feat_convs": feat_p,
        "merge_convs": merge_p,
        "flow_blocks": flow_p,
    }
    state = {"interp": interp_s, "feat_convs": feat_s}
    return params, state


def load_discrete_checkpoint(path: str):
    """One-call loader: torch .pt -> (params, state) of numpy arrays."""
    return convert_discrete(load_torch_state_dict(path))


def _encoder_trees(sd: dict, num_blocks: int):
    """Shared interp/feat/merge conversion (identical in both families)."""
    de_p, de_s = _mlp3(sd, "interp.knn_context.distance_encoder.mlp")
    fc_p, fc_s = _feature_extract(sd, "interp.knn_context.feat_conv",
                                  num_conv=128 // 16)
    wu_p, wu_s = _mlp3(sd, "interp.weight_unit.mlp")
    interp_p = {
        "knn_context": {"distance_encoder": de_p, "feat_conv": fc_p},
        "weight_unit": wu_p,
    }
    interp_s = {
        "knn_context": {"distance_encoder": de_s, "feat_conv": fc_s},
        "weight_unit": wu_s,
    }
    odims = [32, 64] + [128] * (num_blocks - 2)
    growths = [8, 16] + [32] * (num_blocks - 2)
    feat_p, feat_s, merge_p = [], [], []
    for i in range(num_blocks):
        fp, fs = _feature_extract(sd, f"feat_convs.{i}",
                                  num_conv=odims[i] // growths[i])
        feat_p.append(fp)
        feat_s.append(fs)
        merge_p.append({
            "conv1": _linear(sd, f"merge_convs.{i}.conv1"),
            "conv2": _linear(sd, f"merge_convs.{i}.conv2", bias=False),
        })
    return interp_p, interp_s, feat_p, feat_s, merge_p


def convert_cnf(sd: dict, num_blocks: int = 6):
    """Reference continuous `PointInterpFlow` state_dict -> (params, state).

    CNF block layout (see reference `cnf.py:40`, `odefunc.py`,
    `diffeq_layers.py:72-77`): per block `cnf.sqrt_end_time` scalar and 3
    ConcatSquashLinear layers (`_layer` with bias, `_hyper_bias` without,
    `_hyper_gate` with). `odefunc._num_evals` is an introspection buffer and
    is dropped.
    """
    if "flow_blocks.0.cnf.sqrt_end_time" not in sd:
        kind = ("discrete" if "flow_blocks.0.actnorm.logs" in sd
                else "unknown")
        raise ValueError(
            f"checkpoint is not a continuous (CNF) state_dict (looks like: "
            f"{kind}); pass model='discrete' to load discrete weights")
    interp_p, interp_s, feat_p, feat_s, merge_p = _encoder_trees(
        sd, num_blocks)

    flow_p = []
    for i in range(num_blocks):
        pre = f"flow_blocks.{i}.cnf"
        layers = []
        j = 0
        while f"{pre}.odefunc.diffeq.layers.{j}._layer.weight" in sd:
            lp = f"{pre}.odefunc.diffeq.layers.{j}"
            layers.append({
                "layer": _linear(sd, f"{lp}._layer"),
                "hyper_bias": _linear(sd, f"{lp}._hyper_bias", bias=False),
                "hyper_gate": _linear(sd, f"{lp}._hyper_gate"),
            })
            j += 1
        flow_p.append({
            "sqrt_end_time": np.asarray(sd[f"{pre}.sqrt_end_time"],
                                        dtype=np.float32),
            "layers": layers,
        })

    params = {
        "interp": interp_p,
        "feat_convs": feat_p,
        "merge_convs": merge_p,
        "flow_blocks": flow_p,
    }
    state = {"interp": interp_s, "feat_convs": feat_s}
    return params, state


def load_cnf_checkpoint(path: str):
    """One-call loader of the CNF family: torch .pt -> (params, state)."""
    return convert_cnf(load_torch_state_dict(path))
