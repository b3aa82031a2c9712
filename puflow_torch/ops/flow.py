"""Forward and inverse flow chains: the CUDA kernels and their plain versions.

Counterpart of `puflow_tpu.ops.pallas.flow_pallas` (`flow_f_pallas`,
`flow_g_pallas` and `flow_g_blend_pallas`, here `csrc/flow_f.cu` and
`csrc/flow_g.cu`) and of the flow-block functions of
`puflow_tpu.models.discrete`. One flow block is
ActNorm -> inv1x1 -> additive coupling (split 1 for even blocks, 2 for
odd) -> reverse channels -> affine injector, each conditioned on the
block's encoder features.

The wrappers `flow_f`, `flow_g` and `flow_g_blend` (the latent blend of
the interpolation, then the inverse flow) launch their kernel for CUDA
tensors and run the plain version (`flow_f_plain`, `flow_g_plain`,
`flow_g_blend_plain`) for CPU tensors. They pack the blocks' weights once
per parameters and direction (`_build.packed`, `_pack`): the B fragments
of both kernels' 3xTF32 products in one layout, whose head differs.
Inference only: no log-determinant, no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from puflow_torch.flows.coupling import (
    additive_coupling_forward,
    additive_coupling_inverse,
    affine_injector_forward,
    affine_injector_inverse,
)
from puflow_torch.flows.normalize import actnorm_forward, actnorm_inverse
from puflow_torch.flows.permutate import (
    inv1x1_forward,
    inv1x1_inverse,
    reverse_permute,
)
from puflow_torch.ops import _build
from puflow_torch.ops.encoder import b_fragments
from puflow_torch.ops.knn import check_graph, gather_points

_REVERSE3 = (2, 1, 0)  # reverse permutation of 3 channels; self-inverse
HDIM = 64              # LinearA1D hidden width the kernels are built for
MAX_CDIM = 128         # widest condition whose block fits shared memory
MAX_BLOCKS = 8
MAX_UPRATIO = 32       # R_MAX of the interpolation head


def _split(i: int) -> int:
    return 1 if i % 2 == 0 else 2


def flow_block_forward(params: dict, x: torch.Tensor, c: torch.Tensor,
                       is_even: bool):
    """One Glow step; logdet sums the actnorm, inv1x1 and injector terms
    (the additive coupling is volume-preserving)."""
    split = 1 if is_even else 2
    x, ld0 = actnorm_forward(params["actnorm"], x)
    x, ld1 = inv1x1_forward(params["inv1x1"], x)
    x, _ = additive_coupling_forward(params["coupling1"], x, c, split)
    x = reverse_permute(x, _REVERSE3)
    x, ld4 = affine_injector_forward(params["coupling2"], x, c)
    return x, ld0 + ld1 + ld4


def flow_block_inverse(params: dict, z: torch.Tensor, c: torch.Tensor,
                       is_even: bool) -> torch.Tensor:
    split = 1 if is_even else 2
    z, _ = affine_injector_inverse(params["coupling2"], z, c)
    z = reverse_permute(z, _REVERSE3)
    z, _ = additive_coupling_inverse(params["coupling1"], z, c, split)
    z, _ = inv1x1_inverse(params["inv1x1"], z)
    z, _ = actnorm_inverse(params["actnorm"], z)
    return z


def flow_f_plain(flow_blocks, x: torch.Tensor, cs) -> torch.Tensor:
    """Points ``[B, N, 3]`` + conditions ``[B, N, cdim_i]`` -> latents
    ``[B, N, 3]``: `discrete.f_transform` without the log-det."""
    for i, (bp, c) in enumerate(zip(flow_blocks, cs)):
        x, _ = flow_block_forward(bp, x, c, is_even=(i % 2 == 0))
    return x


def flow_g_plain(flow_blocks, fz: torch.Tensor, cs) -> torch.Tensor:
    """Latents ``[B, N, 3, r]`` + un-repeated conditions ``[B, N, cdim_i]``
    -> points ``[B, N * r, 3]``, point-major (a point's r samples are
    consecutive rows): the XLA branch of `discrete.g_transform`."""
    B, N, C, r = fz.shape
    z = fz.transpose(2, 3).reshape(B, N * r, C)
    for i in reversed(range(len(flow_blocks))):
        c = torch.repeat_interleave(cs[i], r, dim=1)
        z = flow_block_inverse(flow_blocks[i], z, c, is_even=(i % 2 == 0))
    return z


def flow_g_blend_plain(flow_blocks, z: torch.Tensor, ws: torch.Tensor,
                       knn_idx: torch.Tensor, cs) -> torch.Tensor:
    """Latents ``[B, N, 3]`` of f, interpolation weights ``[B, N, K, r]``
    and their K-NN graph ``[B, N, K]`` -> points ``[B, N * r, 3]``: the
    blend ``sum_k z[idx_k] ws_k`` followed by `flow_g_plain`."""
    nei = gather_points(z, knn_idx)                        # [B, N, K, 3]
    fz = torch.einsum("bnkc,bnkr->bncr", nei, ws)
    return flow_g_plain(flow_blocks, fz, cs)


def k_chunks(cdim: int) -> int:
    """k8 chunks the kernels take over a condition of width cdim
    (`csrc/flow_common.cuh:kt_of`): 4, 8 or 16, zero rows past cdim."""
    return 4 if cdim <= 32 else 8 if cdim <= 64 else 16


def _pad(t: torch.Tensor, rows: int | None = None, cols: int | None = None):
    """Zero-pad a vector to ``rows`` entries or a matrix to ``[rows,
    cols]``."""
    if t.ndim == 1:
        return torch.cat([t, t.new_zeros(rows - t.shape[0])])
    rows = t.shape[0] if rows is None else rows
    cols = t.shape[1] if cols is None else cols
    out = t.new_zeros(rows, cols)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _pack(flow_blocks, inverse: bool):
    """Flow-block params -> (flat f32 weights, per-block offsets) in the
    layout `csrc/flow_common.cuh` describes: per block a head of 16 floats,
    c_w0's h1 rows, the biases, then the B fragments of s_w0, b_w0, c_w0's
    condition rows, s_w2, b_w2, c_w2 (f32 pairs) and s_w1, b_w1, c_w1
    (pre-split); the 64 -> 3 layers zero-padded to 8 columns, the first
    layers' rows to 8 `k_chunks`. The head is what each direction's 3-wide
    steps take: forward (flow f) exp(logs), the ActNorm bias and W;
    inverse (flow g) the bias, exp(-logs) and W^-1."""
    pieces, woff = [], [0]
    for i, bp in enumerate(flow_blocks):
        split = _split(i)
        an = bp["actnorm"]
        c1 = bp["coupling1"]["bias_net"]
        sn, bn = bp["coupling2"]["scale_net"], bp["coupling2"]["bias_net"]
        kp = 8 * k_chunks(sn["w0"].shape[0])
        w = bp["inv1x1"]["W"]
        if inverse:
            # linalg.inv without its error check, whose read of the status
            # would stop the host until the card drains its queue
            w = torch.linalg.inv_ex(w).inverse
            head = [an["bias"], torch.exp(-an["logs"])]
        else:
            head = [torch.exp(an["logs"]), an["bias"]]
        block = [t.reshape(-1) for t in head + [w]] + [w.new_zeros(1)]
        block += [_pad(c1["w0"][:split], rows=2).reshape(-1),
                  c1["b1"], sn["b1"], bn["b1"],
                  _pad(c1["b2"], 8), _pad(sn["b2"], 8), _pad(bn["b2"], 8)]
        block += [b_fragments(_pad(w0, rows=kp), False)
                  for w0 in (sn["w0"], bn["w0"], c1["w0"][split:])]
        block += [b_fragments(_pad(net["w2"], cols=8), False)
                  for net in (sn, bn, c1)]
        block += [b_fragments(net["w1"], True) for net in (sn, bn, c1)]
        pieces.extend(block)
        woff.append(woff[-1] + sum(t.numel() for t in block))
    return torch.cat(pieces).to(torch.float32).contiguous(), woff


def _packed_leaves(leaves, tree: str, inverse: bool):
    """The kernels' packing of the flow blocks that `_build.flatten` gave
    (``leaves``, ``tree``), made once per parameters and direction
    (`_build.packed`); the blocks are rebuilt only to pack them."""
    return _build.packed(
        leaves, lambda: _pack(_build.unflatten(leaves, tree), inverse),
        "flow_g" if inverse else "flow_f")


def _packed(flow_blocks, inverse: bool):
    """`_packed_leaves` of the flow blocks."""
    return _packed_leaves(*_build.flatten(list(flow_blocks)), inverse)


def _check_tensors(name: str, points: torch.Tensor, cs) -> None:
    """Raise unless the input and the conditions are what the kernels read:
    contiguous float32 on one device, a condition row per point, widths
    even, at most `MAX_CDIM` and 8-byte aligned (the kernels read a
    condition's columns in pairs)."""
    if points.dtype != torch.float32 or not points.is_contiguous():
        raise ValueError(f"{name}: expects contiguous float32 input, got "
                         f"{points.dtype}")
    if not 1 <= len(cs) <= MAX_BLOCKS:
        raise ValueError(f"{name}: {len(cs)} conditions (1 to {MAX_BLOCKS})")
    for i, c in enumerate(cs):
        if (c.device != points.device or c.dtype != torch.float32
                or not c.is_contiguous()):
            raise ValueError(f"{name}: condition {i} must be contiguous "
                             f"float32 on {points.device}")
        if c.shape[:-1] != points.shape[:2] or c.shape[-1] > MAX_CDIM:
            raise ValueError(f"{name}: condition {i} has shape "
                             f"{tuple(c.shape)}; expected "
                             f"{tuple(points.shape[:2])} + (<= {MAX_CDIM},)")
        if c.shape[-1] % 2 or c.data_ptr() % 8:
            raise ValueError(f"{name}: condition {i} must have an even width "
                             f"and 8-byte aligned rows, got width "
                             f"{c.shape[-1]} at address {c.data_ptr()}")


def _check_blocks(name: str, flow_blocks, points: torch.Tensor, cs) -> None:
    """Raise unless the flow blocks are what the kernels take for these
    conditions: one block a condition, on the input's device, hidden width
    `HDIM`, each block's first layer as wide as its condition."""
    if len(cs) != len(flow_blocks):
        raise ValueError(f"{name}: {len(cs)} conditions for "
                         f"{len(flow_blocks)} blocks")
    for i, (bp, c) in enumerate(zip(flow_blocks, cs)):
        if bp["inv1x1"]["W"].device != points.device:
            raise ValueError(f"{name}: block {i} is not on {points.device}")
        if bp["coupling1"]["bias_net"]["w1"].shape != (HDIM, HDIM):
            raise ValueError(f"{name}: kernels take hidden width {HDIM}")
        if bp["coupling1"]["bias_net"]["w0"].shape[0] != (
                c.shape[-1] + _split(i)):
            raise ValueError(f"{name}: block {i} does not match its "
                             "condition width")


def _launch_args(leaves, tree: str, cs, inverse: bool):
    """What every flow kernel takes beside its own tensors: the packed
    weights, and the host arrays of the conditions' pointers, their widths
    and the blocks' offsets."""
    weights, woff = _packed_leaves(leaves, tree, inverse)
    return (weights,
            (ctypes.c_longlong * len(cs))(*(c.data_ptr() for c in cs)),
            (ctypes.c_int * len(cs))(*(c.shape[-1] for c in cs)),
            (ctypes.c_int * len(woff))(*woff))


def _launch_f(x: torch.Tensor, cs, leaves, tree: str) -> torch.Tensor:
    """Launch `csrc/flow_f.cu` on checked CUDA tensors; ``leaves`` and
    ``tree`` (`_build.flatten`) are the flow blocks."""
    weights, c_ptrs, cdims, woff_c = _launch_args(leaves, tree, cs,
                                                  inverse=False)
    z = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.puflow_flow_f(
            x.data_ptr(), weights.data_ptr(), ctypes.addressof(c_ptrs),
            ctypes.addressof(cdims), ctypes.addressof(woff_c), len(cs),
            x.shape[0] * x.shape[1], z.data_ptr(),
            _build.stream_ptr(x.device))
    _build.check(code, "puflow_flow_f")
    return z


def _launch_g(fz: torch.Tensor, cs, leaves, tree: str) -> torch.Tensor:
    """Launch `csrc/flow_g.cu:puflow_flow_g` on checked CUDA tensors."""
    weights, c_ptrs, cdims, woff_c = _launch_args(leaves, tree, cs,
                                                  inverse=True)
    B, N, C, r = fz.shape
    out = torch.empty((B, N * r, C), dtype=torch.float32, device=fz.device)
    lib = _build.library()
    with torch.cuda.device(fz.device):
        code = lib.puflow_flow_g(
            fz.data_ptr(), weights.data_ptr(), ctypes.addressof(c_ptrs),
            ctypes.addressof(cdims), ctypes.addressof(woff_c), len(cs),
            B * N, r, out.data_ptr(), _build.stream_ptr(fz.device))
    _build.check(code, "puflow_flow_g")
    return out


def _launch_g_blend(z: torch.Tensor, ws: torch.Tensor, knn_idx: torch.Tensor,
                    cs, leaves, tree: str) -> torch.Tensor:
    """Launch `csrc/flow_g.cu:puflow_flow_g_blend` on checked CUDA
    tensors."""
    weights, c_ptrs, cdims, woff_c = _launch_args(leaves, tree, cs,
                                                  inverse=True)
    B, N, C = z.shape
    k, r = knn_idx.shape[2], ws.shape[3]
    out = torch.empty((B, N * r, C), dtype=torch.float32, device=z.device)
    lib = _build.library()
    with torch.cuda.device(z.device):
        code = lib.puflow_flow_g_blend(
            z.data_ptr(), ws.data_ptr(), knn_idx.data_ptr(),
            knn_idx.stride(1), N, k, weights.data_ptr(),
            ctypes.addressof(c_ptrs), ctypes.addressof(cdims),
            ctypes.addressof(woff_c), len(cs), B * N, r, out.data_ptr(),
            _build.stream_ptr(z.device))
    _build.check(code, "puflow_flow_g_blend")
    return out


@torch.library.custom_op("puflow::flow_f", mutates_args=(),
                         device_types="cuda")
def _flow_f_op(x: torch.Tensor, cs: list[torch.Tensor],
               leaves: list[torch.Tensor], tree: str) -> torch.Tensor:
    if x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"flow_f: expects [B, N, 3], got {tuple(x.shape)}")
    _check_tensors("flow_f", x, cs)
    z = _launch_f(x, cs, leaves, tree)
    flow_f.launches += 1
    return z


@torch.library.custom_op("puflow::flow_g", mutates_args=(),
                         device_types="cuda")
def _flow_g_op(fz: torch.Tensor, cs: list[torch.Tensor],
               leaves: list[torch.Tensor], tree: str) -> torch.Tensor:
    if fz.ndim != 4 or fz.shape[2] != 3 or not 1 <= fz.shape[3] <= MAX_UPRATIO:
        raise ValueError("flow_g: expects [B, N, 3, r] with r <= "
                         f"{MAX_UPRATIO}, got {tuple(fz.shape)}")
    _check_tensors("flow_g", fz, cs)
    out = _launch_g(fz, cs, leaves, tree)
    flow_g.launches += 1
    return out


@torch.library.custom_op("puflow::flow_g_blend", mutates_args=(),
                         device_types="cuda")
def _flow_g_blend_op(z: torch.Tensor, ws: torch.Tensor, knn_idx: torch.Tensor,
                     cs: list[torch.Tensor], leaves: list[torch.Tensor],
                     tree: str) -> torch.Tensor:
    if z.ndim != 3 or z.shape[2] != 3:
        raise ValueError(f"flow_g_blend: expects z [B, N, 3], got "
                         f"{tuple(z.shape)}")
    B, N, _ = z.shape
    k = check_graph("flow_g_blend", knn_idx, z)
    if (ws.dtype != torch.float32 or ws.device != z.device
            or not ws.is_contiguous() or ws.ndim != 4
            or ws.shape[:3] != (B, N, k)
            or not 1 <= ws.shape[3] <= MAX_UPRATIO):
        raise ValueError("flow_g_blend: expects contiguous float32 ws "
                         f"[{B}, {N}, {k}, r <= {MAX_UPRATIO}], got "
                         f"{ws.dtype} {tuple(ws.shape)}")
    _check_tensors("flow_g_blend", z, cs)
    out = _launch_g_blend(z, ws, knn_idx, cs, leaves, tree)
    flow_g_blend.launches += 1
    return out


@_flow_f_op.register_kernel("cpu")
def _(x, cs, leaves, tree):
    return flow_f_plain(_build.unflatten(leaves, tree), x, cs)


@_flow_g_op.register_kernel("cpu")
def _(fz, cs, leaves, tree):
    return flow_g_plain(_build.unflatten(leaves, tree), fz, cs)


@_flow_g_blend_op.register_kernel("cpu")
def _(z, ws, knn_idx, cs, leaves, tree):
    return flow_g_blend_plain(_build.unflatten(leaves, tree), z, ws, knn_idx,
                              cs)


@_flow_f_op.register_fake
def _(x, cs, leaves, tree):
    return torch.empty_like(x)


@_flow_g_op.register_fake
def _(fz, cs, leaves, tree):
    B, N, C, r = fz.shape
    return fz.new_empty((B, N * r, C))


@_flow_g_blend_op.register_fake
def _(z, ws, knn_idx, cs, leaves, tree):
    B, N, C = z.shape
    return z.new_empty((B, N * ws.shape[3], C))


def _blocks_on_card(name: str, flow_blocks, points: torch.Tensor, cs):
    """``(leaves, tree)`` of the blocks for the op; on a CUDA tensor the
    blocks are first held to what the kernels take (`_check_blocks`)."""
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {points.device}")
    if points.device.type == "cuda":
        _check_blocks(name, flow_blocks, points, cs)
    return _build.flatten(list(flow_blocks))


def flow_f(flow_blocks, x: torch.Tensor, cs) -> torch.Tensor:
    """Forward flow, points ``[B, N, 3]`` -> latents ``[B, N, 3]``, with no
    log-det, through the op ``puflow::flow_f``: the CUDA kernel for CUDA
    tensors, `flow_f_plain` for CPU."""
    leaves, tree = _blocks_on_card("flow_f", flow_blocks, x, cs)
    return torch.ops.puflow.flow_f(x, list(cs), leaves, tree)


def flow_g(flow_blocks, fz: torch.Tensor, cs) -> torch.Tensor:
    """Inverse flow, latents ``[B, N, 3, r]`` + un-repeated conditions ->
    points ``[B, N * r, 3]`` point-major, through the op
    ``puflow::flow_g``: the CUDA kernel for CUDA tensors, `flow_g_plain`
    for CPU."""
    leaves, tree = _blocks_on_card("flow_g", flow_blocks, fz, cs)
    return torch.ops.puflow.flow_g(fz, list(cs), leaves, tree)


def flow_g_blend(flow_blocks, z: torch.Tensor, ws: torch.Tensor,
                 knn_idx: torch.Tensor, cs) -> torch.Tensor:
    """Latent blend plus inverse flow, ``[B, N * r, 3]`` point-major (see
    `flow_g_blend_plain`), through the op ``puflow::flow_g_blend``: the
    CUDA kernel for CUDA tensors, whose prologue blends each point's
    latents, the plain version for CPU."""
    leaves, tree = _blocks_on_card("flow_g_blend", flow_blocks, z, cs)
    return torch.ops.puflow.flow_g_blend(z, ws, knn_idx, list(cs), leaves,
                                         tree)


flow_f.launches = 0
flow_g.launches = 0
flow_g_blend.launches = 0
