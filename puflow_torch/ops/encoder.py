"""Condition encoder on BN-folded params: the CUDA kernel and its plain
version.

Counterpart of the TPU kernels `ops/pallas/encoder_pallas.py:
encoder_conditions_pallas` and `encoder_conditions_pallas_cm` (here one
kernel, `csrc/encoder.cu`): the discrete model's six densely connected
EdgeConv blocks over a K-NN graph, each block's output pooled over the K
slots and merged into that block's flow condition. The plain version is
the port's `discrete.feat_extract` on folded params.
"""

from __future__ import annotations

import ctypes

import torch

from puflow_torch.models.encoder import feat_merge_apply, feature_extract_apply
from puflow_torch.ops import _build
from puflow_torch.ops.knn import check_graph, check_patches

MAX_LAYERS = 8            # growth layers per block (csrc/encoder.cu)
_META = 10 + 2 * (MAX_LAYERS + 1)
_WIDTHS = (8, 16, 32, 64, 128)
_MAX_GT = 256             # projection columns of a block
_MAX_ODIM = 128


def encoder_conditions_plain(params, xyz: torch.Tensor,
                             knn_idx: torch.Tensor, state=None):
    """EdgeConv pyramid -> per-block conditions ``[B, N, cdim_i]``.
    ``state`` holds the BN statistics of unfolded params (None when
    folded)."""
    cs = []
    c = xyz
    for i, (fp, mp) in enumerate(zip(params["feat_convs"],
                                     params["merge_convs"])):
        fs = None if state is None else state["feat_convs"][i]
        c, _ = feature_extract_apply(fp, fs, c, knn_idx)
        cs.append(feat_merge_apply(mp, c))
    return cs


def _pack(params):
    """Folded encoder params -> (flat f32 weights, [nblocks * _META] int
    metadata) in the layout `csrc/encoder.cu` reads."""
    pieces, meta, off = [], [], 0

    def put(t):
        nonlocal off
        pieces.append(t.reshape(-1))
        off += t.numel()
        return off - t.numel()

    for b, (fp, mp) in enumerate(zip(params["feat_convs"],
                                     params["merge_convs"])):
        if any("bn" in conv for conv in fp["convs"]):
            raise ValueError("encoder_conditions: the kernel takes BN-folded "
                             "params (models.fold_bn.fold_bn_inference)")
        layers = [conv["lin"] for conv in fp["convs"]] + [fp["conv_out"]]
        c = layers[0]["w"].shape[0] // 3
        g = layers[0]["w"].shape[1]
        n_layers = len(fp["convs"])
        odim = layers[-1]["w"].shape[1]
        cdim = mp["conv2"]["w"].shape[1]
        gt = n_layers * g + odim
        shapes_ok = (
            all(lay["w"].shape == (3 * c + j * g, g)
                for j, lay in enumerate(layers[:-1]))
            and layers[-1]["w"].shape == (3 * c + n_layers * g, odim)
            and mp["conv1"]["w"].shape == (odim, odim // 2)
            and mp["conv2"]["w"].shape == (odim // 2, cdim))
        if not (shapes_ok and 1 <= n_layers <= MAX_LAYERS
                and g in _WIDTHS and odim in _WIDTHS and odim // 2 in _WIDTHS
                and cdim in _WIDTHS and gt <= _MAX_GT
                and (gt % 128 == 0 or gt % 128 in _WIDTHS)):
            raise ValueError(f"encoder_conditions: block {b} has a shape the "
                             "kernel does not take")
        w_self = torch.cat([lay["w"][:c] - lay["w"][2 * c:3 * c]
                            for lay in layers], dim=1)
        w_nbr = torch.cat([lay["w"][c:2 * c] + lay["w"][2 * c:3 * c]
                           for lay in layers], dim=1)
        rec = [c, g, n_layers, odim, cdim, put(w_self), put(w_nbr),
               put(mp["conv1"]["w"]), put(mp["conv1"]["b"]),
               put(mp["conv2"]["w"])]
        bias = [put(lay["b"]) for lay in layers]
        w_h = [-1] + [put(lay["w"][3 * c:]) for lay in layers[1:]]
        pad = [-1] * (MAX_LAYERS - n_layers)
        meta.extend(rec + bias + pad + w_h + pad)
    weights = torch.cat(pieces).to(torch.float32).contiguous()
    return weights, meta


def encoder_conditions(params, xyz: torch.Tensor, knn_idx: torch.Tensor):
    """Six conditions ``[B, n, cdim_i]`` of folded params from patches
    ``[B, n, 3]`` and their K-NN graph ``[B, n, K]`` (indices within each
    patch): the CUDA kernel for CUDA tensors, the plain version for CPU."""
    if xyz.device.type == "cpu":
        return encoder_conditions_plain(params, xyz, knn_idx)
    if xyz.device.type != "cuda":
        raise ValueError(f"encoder_conditions: no kernel for {xyz.device}")
    check_patches("encoder_conditions", xyz)
    k = check_graph("encoder_conditions", knn_idx, xyz)
    B, n, _ = xyz.shape
    weights, meta = _pack(params)
    cdims = [mp["conv2"]["w"].shape[1] for mp in params["merge_convs"]]
    cs = [torch.empty((B, n, cd), dtype=torch.float32, device=xyz.device)
          for cd in cdims]
    scratch = torch.empty(B * n * (2 * _MAX_GT + _MAX_ODIM),
                          dtype=torch.float32, device=xyz.device)
    meta_c = (ctypes.c_int * len(meta))(*meta)
    out_ptrs = (ctypes.c_longlong * len(cs))(*(c.data_ptr() for c in cs))
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        code = lib.puflow_encoder(
            xyz.data_ptr(), knn_idx.data_ptr(), knn_idx.stride(1), B * n, n,
            k, weights.data_ptr(), ctypes.addressof(meta_c), len(cdims),
            ctypes.addressof(out_ptrs), scratch.data_ptr(),
            _build.stream_ptr(xyz.device))
    _build.check(code, "puflow_encoder")
    encoder_conditions.launches += 1
    return cs


encoder_conditions.launches = 0
