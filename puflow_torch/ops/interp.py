"""Interpolation head on BN-folded params: the CUDA kernel and its plain
version.

Counterpart of the TPU kernels `ops/pallas/encoder_pallas.py:
interp_weights_cm_pallas` / `interp_weights_cm_pallas_t` (softmaxed
weights), `interp_logits_pallas` (logits) and `interp_latents_pallas`
(weights blended into latents), here one kernel, `csrc/interp.cu`, with a
``mode`` per epilogue. From each point's K neighbours: the distance
encoder and the context EdgeConv make a 256-channel context per slot, the
weight MLP turns it into R_MAX=32 logits, and the first r logits are
softmaxed over the K slots.
"""

from __future__ import annotations

import ctypes

import torch

from puflow_torch.models.encoder import (R_MAX, knn_context_apply,
                                         weight_unit_apply)
from puflow_torch.ops import _build
from puflow_torch.ops.knn import check_graph, check_patches, gather_points

MODES = ("logits", "weights", "latents")
# the published head, which the kernel's row layout is built for
_DE_SHAPES = [(10, 64), (64, 64), (64, 128)]
_FEU_LAYERS, _GROWTH, _FEU_ODIM = 8, 16, 128
_WU_SHAPES = [(256, 128), (128, 64), (64, R_MAX)]


def interp_head_plain(params, xyz: torch.Tensor, knn_idx: torch.Tensor,
                      upratio: int, mode: str = "weights",
                      z: torch.Tensor | None = None, state=None,
                      train: bool = False):
    """The head as tensor ops. xyz ``[B, n, 3]``, knn_idx ``[B, n, K]`` ->
    ``logits`` ``[B, n, K, R_MAX]``, ``weights`` ``[B, n, K, r]`` (softmax
    over the K slots) or ``latents`` ``[B, n, 3, r]`` from z ``[B, n, 3]``.
    ``state`` holds the BN statistics of unfolded params (None when
    folded). ``train=True`` runs BN on batch statistics and returns
    ``(out, new_state)``; otherwise the output alone."""
    kc_s = wu_s = None
    if state is not None:
        kc_s, wu_s = state["knn_context"], state["weight_unit"]
    ctx, kc_s = knn_context_apply(params["knn_context"], kc_s, xyz, knn_idx,
                                  train)
    out, wu_s = weight_unit_apply(params["weight_unit"], wu_s, ctx, train)
    if mode != "logits":
        out = torch.softmax(out[..., :upratio], dim=2)     # over the slots
    if mode == "latents":
        nei = gather_points(z, knn_idx)                    # [B, n, K, 3]
        out = torch.einsum("bnkc,bnkr->bncr", nei, out)
    if train:
        return out, {"knn_context": kc_s, "weight_unit": wu_s}
    return out


def _pack(params):
    """Folded head params -> (flat f32 weights, offsets of the 15 weight
    matrices then of the 15 biases) in `csrc/interp.cu`'s order. Each
    context EdgeConv layer gets the rows [W_self; W_nbr; 0 (4 rows); W_h]
    over the kernel's [f10, h] row layout."""
    kc = params["knn_context"]
    de, fe, wu = kc["distance_encoder"], kc["feat_conv"], params["weight_unit"]
    if "bn0" in de or "bn0" in wu or any("bn" in c for c in fe["convs"]):
        raise ValueError("interp_head: the kernel takes BN-folded params "
                         "(models.fold_bn.fold_bn_inference)")
    layers = [fe_c["lin"] for fe_c in fe["convs"]] + [fe["conv_out"]]
    shapes_ok = (
        [tuple(de[f"lin{i}"]["w"].shape) for i in range(3)] == _DE_SHAPES
        and [tuple(wu[f"lin{i}"]["w"].shape) for i in range(3)] == _WU_SHAPES
        and len(layers) == _FEU_LAYERS + 1
        and all(tuple(lay["w"].shape) == (9 + _GROWTH * j, _GROWTH)
                for j, lay in enumerate(layers[:-1]))
        and tuple(layers[-1]["w"].shape) == (9 + _GROWTH * _FEU_LAYERS,
                                             _FEU_ODIM))
    if not shapes_ok:
        raise ValueError("interp_head: the kernel is built for the published "
                         "head (distance MLP 10-64-64-128, growth-16 x 8 "
                         "EdgeConv, weight MLP 256-128-64-32)")
    mats = [de[f"lin{i}"]["w"] for i in range(3)]
    biases = [de[f"lin{i}"]["b"] for i in range(3)]
    for lay in layers:
        w = lay["w"]
        zero = torch.zeros((4, w.shape[1]), dtype=w.dtype, device=w.device)
        mats.append(torch.cat([w[:3] - w[6:9], w[3:6] + w[6:9], zero, w[9:]]))
        biases.append(lay["b"])
    mats += [wu[f"lin{i}"]["w"] for i in range(3)]
    biases += [wu[f"lin{i}"]["b"] for i in range(3)]
    pieces = [t.reshape(-1) for t in mats + biases]
    offsets = [0]
    for t in pieces[:-1]:
        offsets.append(offsets[-1] + t.numel())
    return torch.cat(pieces).to(torch.float32).contiguous(), offsets


def interp_head(params, xyz: torch.Tensor, knn_idx: torch.Tensor,
                upratio: int, mode: str = "weights",
                z: torch.Tensor | None = None):
    """The folded interpolation head (see `interp_head_plain` for shapes):
    the CUDA kernel for CUDA tensors, the plain version for CPU."""
    if mode not in MODES:
        raise ValueError(f"interp_head: mode {mode!r} not in {MODES}")
    if not 1 <= upratio <= R_MAX:
        raise ValueError(f"interp_head: upratio={upratio} outside "
                         f"[1, {R_MAX}]")
    if xyz.device.type == "cpu":
        return interp_head_plain(params, xyz, knn_idx, upratio, mode, z)
    if xyz.device.type != "cuda":
        raise ValueError(f"interp_head: no kernel for {xyz.device}")
    check_patches("interp_head", xyz)
    k = check_graph("interp_head", knn_idx, xyz)
    B, n, _ = xyz.shape
    if mode == "latents" and (
            z is None or z.shape != xyz.shape or z.dtype != torch.float32
            or z.device != xyz.device or not z.is_contiguous()):
        raise ValueError("interp_head: mode 'latents' takes contiguous "
                         f"float32 z of shape {tuple(xyz.shape)}")
    shape = {"logits": (B, n, k, R_MAX), "weights": (B, n, k, upratio),
             "latents": (B, n, 3, upratio)}[mode]
    out = torch.empty(shape, dtype=torch.float32, device=xyz.device)
    weights, offsets = _pack(params)
    off_c = (ctypes.c_int * len(offsets))(*offsets)
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        code = lib.puflow_interp_head(
            xyz.data_ptr(), knn_idx.data_ptr(), knn_idx.stride(1), B * n, n,
            k, weights.data_ptr(), ctypes.addressof(off_c),
            MODES.index(mode), upratio,
            z.data_ptr() if mode == "latents" else None, out.data_ptr(),
            _build.stream_ptr(xyz.device))
    _build.check(code, "puflow_interp_head")
    interp_head.launches += 1
    return out


interp_head.launches = 0
