"""Reference-format checkpoints from numpy parameter trees, for the tests of
the `.pt` converters and for `chip_smoke.py`.

`reference_state_dict` is the inverse of `convert_discrete` /
`convert_cnf` (`puflow_tpu.convert.torch_ckpt`, copied in
`puflow_torch.convert.torch_ckpt`): it lays out (params, state) trees in
the JAX package's keys as the reference's ``state_dict`` keys and layouts
(Linear ``[out, in]``, Conv ``[out, in, 1, 1]``), with the buffers the
converters drop: BatchNorm's ``num_batches_tracked``, the static reverse
permutation's ``direct_idx`` / ``inverse_idx`` and the CNF's
``odefunc._num_evals``. Imports numpy and torch only.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

NUM_BLOCKS = 6
# numbers in the reference's shipped checkpoints (tests/test_model.py,
# tests/test_cnf.py): puflow-x4-pu1k.pt and its continuous counterpart
REFERENCE_NUMBERS = {"discrete": 808_287, "cnf": 802_376}


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _conv1x1(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T[:, :, None, None])
    sd[f"{prefix}.bias"] = _t(p["b"])


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _feature_extract(sd, prefix, p, s):
    for i, (conv, bn_s) in enumerate(zip(p["convs"], s["convs"])):
        _conv1x1(sd, f"{prefix}.convs.{i}.0", conv["lin"])
        _bn(sd, f"{prefix}.convs.{i}.1", conv["bn"], bn_s)
    _conv1x1(sd, f"{prefix}.conv_out", p["conv_out"])


def _mlp3(sd, prefix, p, s):
    _conv1x1(sd, f"{prefix}.0", p["lin0"])
    _bn(sd, f"{prefix}.1", p["bn0"], s["bn0"])
    _conv1x1(sd, f"{prefix}.3", p["lin1"])
    _bn(sd, f"{prefix}.4", p["bn1"], s["bn1"])
    _conv1x1(sd, f"{prefix}.6", p["lin2"])


def _linear_a1d(sd, prefix, p):
    sd[f"{prefix}.layers.0.weight"] = _t(np.asarray(p["w0"]).T)
    for j, i in ((1, 2), (2, 4)):
        sd[f"{prefix}.layers.{i}.weight"] = _t(np.asarray(p[f"w{j}"]).T)
        sd[f"{prefix}.layers.{i}.bias"] = _t(p[f"b{j}"])


def reference_state_dict(params, state, family: str = "discrete",
                         permutation=(2, 1, 0)) -> OrderedDict:
    """numpy (params, state) trees of ``family`` ("discrete" or "cnf") ->
    the reference's ``state_dict`` of torch CPU tensors, for
    ``torch.save``. ``permutation`` is written as each discrete block's
    reverse-permutation buffers (the converters accept only (2, 1, 0))."""
    sd = OrderedDict()
    ip, ist = params["interp"], state["interp"]
    kc, kcs = ip["knn_context"], ist["knn_context"]
    _mlp3(sd, "interp.knn_context.distance_encoder.mlp",
          kc["distance_encoder"], kcs["distance_encoder"])
    _feature_extract(sd, "interp.knn_context.feat_conv", kc["feat_conv"],
                     kcs["feat_conv"])
    _mlp3(sd, "interp.weight_unit.mlp", ip["weight_unit"],
          ist["weight_unit"])
    for i in range(NUM_BLOCKS):
        _feature_extract(sd, f"feat_convs.{i}", params["feat_convs"][i],
                         state["feat_convs"][i])
        merge = params["merge_convs"][i]
        _linear(sd, f"merge_convs.{i}.conv1", merge["conv1"])
        _linear(sd, f"merge_convs.{i}.conv2", merge["conv2"])
    for i, bp in enumerate(params["flow_blocks"]):
        pre = f"flow_blocks.{i}"
        if family == "discrete":
            sd[f"{pre}.actnorm.logs"] = _t(bp["actnorm"]["logs"])
            sd[f"{pre}.actnorm.bias"] = _t(bp["actnorm"]["bias"])
            sd[f"{pre}.permutate1.permutater.W"] = _t(bp["inv1x1"]["W"])
            for name in ("direct_idx", "inverse_idx"):
                sd[f"{pre}.permutate2.permutater.{name}"] = torch.tensor(
                    permutation, dtype=torch.int64)
            _linear_a1d(sd, f"{pre}.coupling1.bias_net",
                        bp["coupling1"]["bias_net"])
            for net in ("scale_net", "bias_net"):
                _linear_a1d(sd, f"{pre}.coupling2.{net}",
                            bp["coupling2"][net])
        else:
            sd[f"{pre}.cnf.sqrt_end_time"] = _t(
                np.asarray(bp["sqrt_end_time"], dtype=np.float32))
            for j, layer in enumerate(bp["layers"]):
                lp = f"{pre}.cnf.odefunc.diffeq.layers.{j}"
                _linear(sd, f"{lp}._layer", layer["layer"])
                _linear(sd, f"{lp}._hyper_bias", layer["hyper_bias"])
                _linear(sd, f"{lp}._hyper_gate", layer["hyper_gate"])
            sd[f"{pre}.cnf.odefunc._num_evals"] = torch.tensor(0.0)
    return sd


def save_reference_checkpoint(path, params, state,
                              family: str = "discrete", **kw) -> None:
    """`reference_state_dict` written with ``torch.save``, as the
    reference saves its checkpoints."""
    torch.save(reference_state_dict(params, state, family, **kw), path)
