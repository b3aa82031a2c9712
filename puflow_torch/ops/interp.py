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
from puflow_torch.ops.encoder import b_fragments
from puflow_torch.ops.knn import check_graph, check_patches, gather_points

MODES = ("logits", "weights", "latents")
# the published head, which the kernel's row layout is built for
_DE_SHAPES = [(10, 64), (64, 64), (64, 128)]
_FEU_LAYERS, _GROWTH, _FEU_ODIM = 8, 16, 128
_WU_SHAPES = [(256, 128), (128, 64), (64, R_MAX)]


def interp_head_plain(params, xyz: torch.Tensor, knn_idx: torch.Tensor,
                      upratio: int, mode: str = "weights",
                      z: torch.Tensor | None = None, state=None,
                      train: bool = False, group=None):
    """The head as tensor ops. xyz ``[B, n, 3]``, knn_idx ``[B, n, K]`` ->
    ``logits`` ``[B, n, K, R_MAX]``, ``weights`` ``[B, n, K, r]`` (softmax
    over the K slots) or ``latents`` ``[B, n, 3, r]`` from z ``[B, n, 3]``.
    ``state`` holds the BN statistics of unfolded params (None when
    folded). ``train=True`` runs BN on batch statistics (the global
    batch's with a `parallel.Group`) and returns ``(out, new_state)``;
    otherwise the output alone."""
    kc_s = wu_s = None
    if state is not None:
        kc_s, wu_s = state["knn_context"], state["weight_unit"]
    ctx, kc_s = knn_context_apply(params["knn_context"], kc_s, xyz, knn_idx,
                                  train, group)
    out, wu_s = weight_unit_apply(params["weight_unit"], wu_s, ctx, train,
                                  group)
    if mode != "logits":
        out = torch.softmax(out[..., :upratio], dim=2)     # over the slots
    if mode == "latents":
        nei = gather_points(z, knn_idx)                    # [B, n, K, 3]
        out = torch.einsum("bnkc,bnkr->bncr", nei, out)
    if train:
        return out, {"knn_context": kc_s, "weight_unit": wu_s}
    return out


# B fragments pre-split into tf32 {hi0, hi1, lo0, lo1} (csrc/interp.cu:
# Frag = float4), or f32 pairs the kernel splits as it reads them (float2)
_PRESPLIT = True
_GROUP = 32               # columns of a group of d or e (csrc/interp.cu)
_F10 = 16                 # f10's columns, zero-padded to two k8 chunks


def _edge_rows(w: torch.Tensor) -> torch.Tensor:
    """A context EdgeConv layer's ``[9 + h, N]`` weights over [x_p, x_q,
    x_q - x_p, h] -> ``[16 + h, N]`` over the kernel's [f10, h]: rows
    [W_self; W_nbr; 0] over f10's 16 columns."""
    zero = w.new_zeros((_F10 - 6, w.shape[1]))
    return torch.cat([w[:3] - w[6:9], w[3:6] + w[6:9], zero, w[9:]])


def _matrices(params):
    """Folded head params -> (the head's [in, out] matrices as the kernel
    takes them: lin0 of the distance MLP padded to f10's 16 rows, the
    EdgeConv layers by `_edge_rows`; the 736 biases in `csrc/interp.cu`'s
    order). Raises unless the params are folded and of the published
    shapes."""
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
    de0 = de["lin0"]["w"]
    mats = {"de0": torch.cat([de0, de0.new_zeros((_F10 - 10,
                                                   de0.shape[1]))]),
            "de1": de["lin1"]["w"], "de2": de["lin2"]["w"],
            "fe": [_edge_rows(lay["w"]) for lay in layers[:-1]],
            "fo": _edge_rows(layers[-1]["w"]),
            "w0": wu["lin0"]["w"], "w1": wu["lin1"]["w"],
            "w2": wu["lin2"]["w"]}
    biases = torch.cat([de[f"lin{i}"]["b"] for i in range(3)]
                       + [lay["b"] for lay in layers]
                       + [wu[f"lin{i}"]["b"] for i in range(3)])
    return mats, biases


def _phases(mats) -> list[list[torch.Tensor]]:
    """The matrices of each phase of `csrc/interp.cu`'s round, in its
    `Phase` order: G (the growth layers), E0-E3 (group i of e: conv_out's
    columns [32 i, +32), W0's rows [128 + 32 i, +32)), D0 (lin0, lin1,
    group 0 of d), D1 (groups 1, 2), D2 (group 3) (group i of d: lin2's
    columns [32 i, +32), W0's rows [32 i, +32)), T (W1, W2)."""
    fo, de2, w0 = mats["fo"], mats["de2"], mats["w0"]

    def e_group(i):
        cols = slice(_GROUP * i, _GROUP * (i + 1))
        return [fo[:, cols], w0[128 + _GROUP * i:128 + _GROUP * (i + 1)]]

    def d_group(i):
        return [de2[:, _GROUP * i:_GROUP * (i + 1)],
                w0[_GROUP * i:_GROUP * (i + 1)]]

    return [mats["fe"], *(e_group(i) for i in range(4)),
            [mats["de0"], mats["de1"], *d_group(0)], d_group(1) + d_group(2),
            d_group(3), [mats["w1"], mats["w2"]]]


def _pack(params):
    """Folded head params -> (flat f32 weights, offsets) in the layout
    `csrc/interp.cu` reads: the biases, then each phase's B fragments
    (`_phases`, `b_fragments`); offsets: the biases', each phase's, the
    end."""
    mats, biases = _matrices(params)
    pieces, offsets = [biases], [0, biases.numel()]
    for phase in _phases(mats):
        pieces += [b_fragments(w, _PRESPLIT) for w in phase]
        offsets.append(offsets[-1] + sum(w.numel() for w in phase)
                       * (2 if _PRESPLIT else 1))
    return torch.cat(pieces).to(torch.float32).contiguous(), offsets


def _packed_leaves(leaves, tree: str):
    """The kernel's packing of the head that `_build.flatten` gave
    (``leaves``, ``tree``), made once per parameters (`_build.packed`);
    the tree is rebuilt only to pack it."""
    return _build.packed(
        leaves, lambda: _pack(_build.unflatten(leaves, tree)), "interp_head")


def _packed(params):
    """`_packed_leaves` of the head's params."""
    return _packed_leaves(*_build.flatten(params))


def _out_shape(xyz: torch.Tensor, k: int, upratio: int, mode: str):
    B, n, _ = xyz.shape
    return {"logits": (B, n, k, R_MAX), "weights": (B, n, k, upratio),
            "latents": (B, n, 3, upratio)}[mode]


def _launch(xyz: torch.Tensor, knn_idx: torch.Tensor, leaves, tree: str,
            upratio: int, mode: str, z: torch.Tensor | None):
    """Launch `csrc/interp.cu` on checked CUDA tensors; ``leaves`` and
    ``tree`` (`_build.flatten`) are the folded head's params."""
    B, n, _ = xyz.shape
    k = knn_idx.shape[2]
    out = torch.empty(_out_shape(xyz, k, upratio, mode),
                      dtype=torch.float32, device=xyz.device)
    weights, offsets = _packed_leaves(leaves, tree)
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
    return out


@torch.library.custom_op("puflow::interp_head", mutates_args=(),
                         device_types="cuda")
def _interp_head_op(xyz: torch.Tensor, knn_idx: torch.Tensor,
                    leaves: list[torch.Tensor], tree: str, upratio: int,
                    mode: str, z: torch.Tensor | None) -> torch.Tensor:
    check_patches("interp_head", xyz)
    check_graph("interp_head", knn_idx, xyz)
    if mode == "latents" and (
            z is None or z.shape != xyz.shape or z.dtype != torch.float32
            or z.device != xyz.device or not z.is_contiguous()):
        raise ValueError("interp_head: mode 'latents' takes contiguous "
                         f"float32 z of shape {tuple(xyz.shape)}")
    out = _launch(xyz, knn_idx, leaves, tree, upratio, mode, z)
    interp_head.launches += 1
    return out


@_interp_head_op.register_kernel("cpu")
def _(xyz, knn_idx, leaves, tree, upratio, mode, z):
    return interp_head_plain(_build.unflatten(leaves, tree), xyz, knn_idx,
                             upratio, mode, z)


@_interp_head_op.register_fake
def _(xyz, knn_idx, leaves, tree, upratio, mode, z):
    return xyz.new_empty(_out_shape(xyz, knn_idx.shape[2], upratio, mode))


def interp_head(params, xyz: torch.Tensor, knn_idx: torch.Tensor,
                upratio: int, mode: str = "weights",
                z: torch.Tensor | None = None):
    """The folded interpolation head (see `interp_head_plain` for shapes)
    through the op ``puflow::interp_head``: the CUDA kernel for CUDA
    tensors, the plain version for CPU."""
    if mode not in MODES:
        raise ValueError(f"interp_head: mode {mode!r} not in {MODES}")
    if not 1 <= upratio <= R_MAX:
        raise ValueError(f"interp_head: upratio={upratio} outside "
                         f"[1, {R_MAX}]")
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"interp_head: no kernel for {xyz.device}")
    leaves, tree = _build.flatten(params)
    return torch.ops.puflow.interp_head(xyz, knn_idx, leaves, tree, upratio,
                                        mode, z)


interp_head.launches = 0
