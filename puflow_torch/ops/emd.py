"""Earth Mover's Distance by the auction algorithm: the CUDA kernel and its
plain version.

Counterpart of `puflow_tpu.ops.emd` and of the TPU kernel
`ops/pallas/emd_pallas.py:emd_auction_pallas` (here `csrc/emd.cu`).
Semantics, per cloud pair (`auction_from_value`, which the JAX package's
tests pin to the reference CUDA kernel):

  * value(i, j) = base(i, j) - price_j, with the base matrix
    ``3 - sqrt(max((|x1_i|^2 + |x2_j|^2) - 2 x1_i.x2_j, 0))`` built once;
  * every unassigned row bids on its best column with the increment
    ``(best - second) + eps`` (top-2 of its values, lowest column on ties);
  * per column, the winner is the lowest row among the unassigned bidders
    whose increment is within 1e-6 of the column's largest; the price
    rises by the winner's own increment and the previous owner becomes
    unassigned;
  * on the last iteration every unassigned row takes its best column
    without displacing anyone (the result need not be a bijection);
  * ``dist[i]`` is the squared distance to the matched point, and the
    gradient flows to xyz1 only: ``2 (x1_i - x2_{a(i)})``.

The plain version builds the base matrix with elementwise tensor ops in
the kernel's operation order (``x0*y0 + x1*y1 + x2*y2``, then
``(sq1 + sq2) - 2 cross``), so on the card the kernel and the plain
version return the same assignments bit for bit.

Unlike the TPU dispatch there is no size gate: the kernel takes any
``n``, and ``m >= 2`` (the top-2 needs two columns).
"""

from __future__ import annotations

import torch

from puflow_torch.ops import _build

_NEG_BIG = -1e9
_SMEM_BYTES = 232448 - 1024  # dynamic shared memory the kernel may ask for
_STATE_WORDS = 4             # state words per row and per column


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """``(x0*x0 + x1*x1) + x2*x2`` over the last axis, in that order."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
            + x[..., 2] * x[..., 2])


def base_value(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """``[B, n, 3]`` x ``[B, m, 3]`` -> ``[B, n, m]``:
    ``3 - sqrt(max((|x|^2 + |y|^2) - 2 x.y, 0))`` in `csrc/emd.cu`'s
    operation order (elementwise ops, no matmul, so no fused multiply-add
    and no reordered sum)."""
    a, b = xyz1[:, :, None, :], xyz2[:, None, :, :]
    cross = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
             + a[..., 2] * b[..., 2])
    sq = _sq_norm(xyz1)[:, :, None] + _sq_norm(xyz2)[:, None, :]
    return 3.0 - torch.sqrt(torch.clamp_min(sq - 2.0 * cross, 0.0))


def auction_from_value(base: torch.Tensor, eps: float, iters: int,
                       unassigned: list | None = None) -> torch.Tensor:
    """Run the auction on value matrices ``[B, n, m]`` -> assignment
    ``[B, n]`` int64 (or ``[n, m]`` -> ``[n]``).

    ``unassigned``, when given, receives each iteration's count of
    unassigned rows per cloud (``[B]`` tensors): the work the auction does.

    A non-finite value is never a row's best or second column, as in the
    kernel; a row with no finite value never bids and stays at -1.
    """
    if base.ndim == 2:
        return auction_from_value(base[None], eps, iters, unassigned)[0]
    B, n, m = base.shape
    dev = base.device
    rows = torch.arange(n, device=dev).expand(B, n)
    assign = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    owner = torch.full((B, m), -1, dtype=torch.int64, device=dev)
    price = torch.zeros((B, m), dtype=base.dtype, device=dev)
    for it in range(iters):
        unass = assign < 0
        if unassigned is not None:
            unassigned.append(unass.sum(dim=1))
        value = base - price[:, None, :]
        value = torch.where(torch.isfinite(value), value, float("-inf"))
        best_j = torch.argmax(value, dim=2)               # first maximum
        best_v = torch.gather(value, 2, best_j[..., None])[..., 0]
        second_v = value.scatter(2, best_j[..., None],
                                 float("-inf")).amax(dim=2)
        bid_inc = (best_v - second_v) + eps
        bids = unass & (best_v > float("-inf"))
        if it == iters - 1:
            # every unassigned row takes its best column, displacing nobody
            return torch.where(bids, best_j, assign)
        masked = torch.where(bids, bid_inc, _NEG_BIG)
        max_inc = torch.full((B, m), _NEG_BIG, dtype=base.dtype, device=dev)
        max_inc = max_inc.scatter_reduce(1, best_j, masked, "amax")
        contends = bids & (bid_inc >= torch.gather(max_inc, 1, best_j)
                           - 1e-6)
        winner = torch.full((B, m), n, dtype=torch.int64, device=dev)
        winner = winner.scatter_reduce(1, best_j,
                                       torch.where(contends, rows, n), "amin")
        got_new = winner < n
        displaced = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
        displaced.scatter_(1, torch.where(got_new & (owner >= 0), owner, n),
                           True)
        won = bids & (torch.gather(winner, 1, best_j) == rows)
        assign = torch.where(won, best_j,
                             torch.where(displaced[:, :n], -1, assign))
        winner_inc = torch.gather(bid_inc, 1, winner.clamp_max(n - 1))
        price = price + torch.where(got_new, winner_inc, 0.0)
        owner = torch.where(got_new, winner, owner)
    return assign


def matched_sqdist(xyz1: torch.Tensor, xyz2: torch.Tensor,
                   assign: torch.Tensor) -> torch.Tensor:
    """``dist[b, i] = |x1_i - x2_{assign_i}|^2`` as ``(d0*d0 + d1*d1) +
    d2*d2``; NaN where ``assign`` is -1 (a row the auction left without a
    column, which only non-finite inputs cause)."""
    idx = assign.clamp_min(0)[..., None].expand(-1, -1, 3)
    dist = _sq_norm(xyz1 - torch.gather(xyz2.detach(), 1, idx))
    return torch.where(assign >= 0, dist, float("nan"))


def emd_auction_plain(xyz1: torch.Tensor, xyz2: torch.Tensor,
                      eps: float = 0.005, iters: int = 50,
                      unassigned: list | None = None):
    """``[B, n, 3]`` x ``[B, m, 3]`` -> ``(dist [B, n], assign [B, n])``
    as tensor ops on any device; ``dist`` is differentiable in xyz1."""
    with torch.no_grad():
        assign = auction_from_value(base_value(xyz1, xyz2), eps, iters,
                                    unassigned)
    return matched_sqdist(xyz1, xyz2, assign), assign


def _check(xyz1: torch.Tensor, xyz2: torch.Tensor, iters: int):
    if (xyz1.ndim != 3 or xyz2.ndim != 3 or xyz1.shape[2] != 3
            or xyz2.shape[2] != 3 or xyz1.shape[0] != xyz2.shape[0]):
        raise ValueError("emd_auction: expects [B, n, 3] and [B, m, 3], got "
                         f"{tuple(xyz1.shape)} and {tuple(xyz2.shape)}")
    if xyz2.shape[1] < 2 or xyz1.shape[1] < 1 or iters < 1:
        raise ValueError("emd_auction: needs n >= 1, m >= 2 and iters >= 1")


def _emd_kernel(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float,
                iters: int):
    """Launch `csrc/emd.cu` on CUDA tensors: (dist [B, n], assign [B, n]
    int64, -1 where a row got no column)."""
    if xyz1.dtype != torch.float32 or xyz2.dtype != torch.float32:
        raise ValueError("emd_auction: the kernel takes float32 clouds")
    if xyz2.device != xyz1.device:
        raise ValueError("emd_auction: clouds on different devices")
    xyz1, xyz2 = xyz1.contiguous(), xyz2.contiguous()
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    dev = xyz1.device
    base = torch.empty((B, n, m), dtype=torch.float32, device=dev)
    words = _STATE_WORDS * (n + m)
    in_smem = words * 4 <= _SMEM_BYTES
    scratch = torch.empty((0 if in_smem else B * words,), dtype=torch.int32,
                          device=dev)
    dist = torch.empty((B, n), dtype=torch.float32, device=dev)
    assign = torch.empty((B, n), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.puflow_emd_auction(
            xyz1.data_ptr(), xyz2.data_ptr(), B, n, m, float(eps), iters,
            base.data_ptr(), scratch.data_ptr() if not in_smem else None,
            dist.data_ptr(), assign.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "puflow_emd_auction")
    emd_auction.launches += 1
    return dist, assign.long()


class _EmdAuction(torch.autograd.Function):
    """The auction's forward (kernel or plain) with the reference's
    backward: ``grad_x1 = grad_dist * 2 (x1 - x2[assign])``, no gradient
    for x2. Rows left without a column get NaN gradients."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, eps, iters):
        if xyz1.device.type == "cuda":
            dist, assign = _emd_kernel(xyz1, xyz2, eps, iters)
        else:
            dist, assign = emd_auction_plain(xyz1, xyz2, eps, iters)
        ctx.save_for_backward(xyz1, xyz2, assign)
        ctx.mark_non_differentiable(assign)
        return dist, assign

    @staticmethod
    def backward(ctx, grad_dist, _grad_assign):
        xyz1, xyz2, assign = ctx.saved_tensors
        idx = assign.clamp_min(0)[..., None].expand(-1, -1, 3)
        matched = torch.gather(xyz2, 1, idx)
        grad = grad_dist[..., None] * 2.0 * (xyz1 - matched)
        grad = torch.where(assign[..., None] >= 0, grad, float("nan"))
        return grad, None, None, None


def emd_auction(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                iters: int = 50):
    """Auction matching ``[B, n, 3]`` x ``[B, m, 3]`` -> ``(dist [B, n],
    assign [B, n] int64)``, differentiable in xyz1: the CUDA kernel for
    CUDA tensors, `emd_auction_plain` for CPU tensors.

    Args:
      xyz1: predicted cloud (the gradient flows here).
      xyz2: target cloud.
      eps: auction slack (the reference trains with 0.005).
      iters: fixed auction iterations (the reference trains with 50).
    """
    if xyz1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"emd_auction: no kernel for {xyz1.device}")
    _check(xyz1, xyz2, iters)
    return _EmdAuction.apply(xyz1, xyz2, float(eps), int(iters))


emd_auction.launches = 0


def emd_loss(preds: torch.Tensor, gts: torch.Tensor,
             radius: torch.Tensor | None = None, eps: float = 0.005,
             iters: int = 50) -> torch.Tensor:
    """Sum-reduced EMD training loss (the reference's `metric/loss.py`)."""
    dist, _ = emd_auction(preds, gts, eps, iters)
    if radius is not None:
        dist = dist / radius[:, None]
    return torch.sum(dist)
