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

SLOT_TILE = 16            # slots of a tensor-core tile (csrc/encoder.cu)
# (growth width g, growth layers, odim) of the blocks the kernel takes: the
# model's (models/discrete.py, GROWTH_WIDTHS and FEAT_CHANNELS)
_EDGE_SHAPES = ((8, 4, 32), (16, 4, 64), (32, 4, 128))
_CDIMS = (32, 64, 128)    # condition widths the kernel takes
_PROJ_COLS = 128          # projection columns a rows phase (csrc/encoder.cu)
_MAX_GT = 256             # projection columns of a block
_MAX_ODIM = 128
# `_pack`'s metadata: ints a block, and where its condition width is
_META_INTS, _META_CDIM = 10, 4


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds: add half the dropped ulp to the
    bits, clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x -> (hi, lo): hi = tf32(x), lo = tf32(x - hi); hi + lo is x to
    about 2^-22 of it (csrc/mma_tf32.cuh)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def fragment_order(w: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` weights (K and N multiples of 8) -> ``[K/8, N/8, 8, 4,
    2]``: the B fragments of ``mma.m16n8k8``, k chunk major. Lane 4 g + t
    of fragment (kc, nt) holds rows 8 kc + 2t and 8 kc + 2t + 1 of column
    8 nt + g: each chunk's rows in the order 0 2 4 6 1 3 5 7, which lets
    a C fragment serve as the next product's A fragment."""
    K, N = w.shape
    return w.reshape(K // 8, 4, 2, N // 8, 8).permute(0, 3, 4, 1, 2)


def b_fragments(w: torch.Tensor, presplit: bool) -> torch.Tensor:
    """``[K, N]`` -> its B fragments (`fragment_order`), flat: each lane's
    pair of weights as f32, or as tf32 {hi0, hi1, lo0, lo1}."""
    pairs = fragment_order(w).reshape(-1, 2)
    if presplit:
        pairs = torch.cat(split_tf32(pairs), dim=1)
    return pairs.reshape(-1)


def pad_slots(knn_idx: torch.Tensor) -> torch.Tensor:
    """``[B, n, K]`` graph -> ``[B, n, K']`` with K' the next multiple of
    SLOT_TILE, each point's first neighbour repeated in the new slots: the
    max over the slots is unchanged."""
    pad = -knn_idx.shape[-1] % SLOT_TILE
    if pad == 0:
        return knn_idx
    first = knn_idx[..., :1].expand(*knn_idx.shape[:-1], pad)
    return torch.cat([knn_idx, first], dim=-1)


def _pack(params):
    """Folded encoder params -> (flat f32 weights, 10 int metadata a block)
    in the layout `csrc/encoder.cu` reads: c, g, n_layers, odim, cdim, then
    float offsets of the edge biases, the merge's b1 and three runs of B
    fragments (`fragment_order`, each pair of values split into tf32 hi
    and lo, float4 {hi0, hi1, lo0, lo1} a lane): the projections [W_self |
    W_nbr] ([c, 2 gt], rows zero-padded to a multiple of 8) 128 columns at
    a time, the merge's W1 and W2, and the products with the growth
    outputs (layers 1.., then conv_out)."""
    plain, plain_len, runs, n_pairs, blocks = [], 0, [], 0, []

    def put(t):
        nonlocal plain_len
        t = t.reshape(-1)
        pad = -t.numel() % 4            # every piece 16-byte aligned
        plain.extend([t, t.new_zeros(pad)])
        plain_len += t.numel() + pad
        return plain_len - t.numel() - pad

    def run(*mats):
        nonlocal n_pairs
        start = n_pairs
        for w in mats:
            runs.append(fragment_order(w).reshape(-1, 2))
            n_pairs += runs[-1].shape[0]
        return start

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
        shapes_ok = (
            all(lay["w"].shape == (3 * c + j * g, g)
                for j, lay in enumerate(layers[:-1]))
            and layers[-1]["w"].shape == (3 * c + n_layers * g, odim)
            and mp["conv1"]["w"].shape == (odim, odim // 2)
            and mp["conv2"]["w"].shape == (odim // 2, cdim))
        if not (shapes_ok and (g, n_layers, odim) in _EDGE_SHAPES
                and cdim in _CDIMS):
            raise ValueError(f"encoder_conditions: block {b} has a shape the "
                             "kernel does not take")
        w_proj = torch.cat([lay["w"][:c] - lay["w"][2 * c:3 * c]
                            for lay in layers]
                           + [lay["w"][c:2 * c] + lay["w"][2 * c:3 * c]
                              for lay in layers], dim=1)
        w_proj = torch.cat([w_proj, w_proj.new_zeros(-c % 8,
                                                     w_proj.shape[1])])
        blocks.append((
            [c, g, n_layers, odim, cdim,
             put(torch.cat([lay["b"] for lay in layers])),
             put(mp["conv1"]["b"])],
            [run(*w_proj.split(_PROJ_COLS, dim=1)),
             run(mp["conv1"]["w"], mp["conv2"]["w"]),
             run(*(lay["w"][3 * c:] for lay in layers[1:]))]))
    frags = torch.cat(split_tf32(torch.cat(runs)), dim=1)   # a pair: 4 floats
    weights = torch.cat(plain + [frags.reshape(-1)]).to(torch.float32)
    meta = [v for head, starts in blocks
            for v in head + [plain_len + 4 * start for start in starts]]
    return weights.contiguous(), meta


def _launch(xyz: torch.Tensor, knn_idx: torch.Tensor, leaves,
            tree: str) -> list[torch.Tensor]:
    """Launch `csrc/encoder.cu` on checked CUDA tensors; ``leaves`` and
    ``tree`` (`_build.flatten`) are the folded ``feat_convs`` and
    ``merge_convs``, packed once per params (`_build.packed`)."""
    knn_idx = pad_slots(knn_idx)
    B, n, _ = xyz.shape
    weights, meta = _build.packed(
        leaves, lambda: _pack(_build.unflatten(leaves, tree)))
    cdims = meta[_META_CDIM::_META_INTS]
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
            knn_idx.shape[-1], weights.data_ptr(), ctypes.addressof(meta_c),
            len(cdims), ctypes.addressof(out_ptrs), scratch.data_ptr(),
            _build.stream_ptr(xyz.device))
    _build.check(code, "puflow_encoder")
    return cs


@torch.library.custom_op("puflow::encoder", mutates_args=(),
                         device_types="cuda")
def _encoder_op(xyz: torch.Tensor, knn_idx: torch.Tensor,
                leaves: list[torch.Tensor], tree: str) -> list[torch.Tensor]:
    check_patches("encoder_conditions", xyz)
    check_graph("encoder_conditions", knn_idx, xyz)
    cs = _launch(xyz, knn_idx, leaves, tree)
    encoder_conditions.launches += 1
    return cs


@_encoder_op.register_kernel("cpu")
def _(xyz, knn_idx, leaves, tree):
    return encoder_conditions_plain(_build.unflatten(leaves, tree), xyz,
                                    knn_idx)


@_encoder_op.register_fake
def _(xyz, knn_idx, leaves, tree):
    params = _build.unflatten(leaves, tree)
    return [xyz.new_empty((xyz.shape[0], xyz.shape[1],
                           mp["conv2"]["w"].shape[1]))
            for mp in params["merge_convs"]]


def encoder_conditions(params, xyz: torch.Tensor, knn_idx: torch.Tensor):
    """Six conditions ``[B, n, cdim_i]`` of folded params from patches
    ``[B, n, 3]`` and their K-NN graph ``[B, n, K]`` (indices within each
    patch), through the op ``puflow::encoder``: the CUDA kernel for CUDA
    tensors, the plain version for CPU."""
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"encoder_conditions: no kernel for {xyz.device}")
    leaves, tree = _build.flatten({"feat_convs": params["feat_convs"],
                                   "merge_convs": params["merge_convs"]})
    return torch.ops.puflow.encoder(xyz, knn_idx, leaves, tree)


encoder_conditions.launches = 0
