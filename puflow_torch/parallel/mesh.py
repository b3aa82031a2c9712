"""A process group over the batch axis and the collectives it needs.

Counterpart of `puflow_tpu.parallel.mesh` (`make_mesh`, `batch_sharding`,
`replicated`). The model is 0.8 M parameters, replicated on every rank,
and all parallelism is over the batch (clouds or patches): `init_group`
brings up a `torch.distributed` process group of one rank a device,
`shard_batch` takes a rank's rows of a global batch as a JAX batch
sharding lays them out, and the rest are the collectives the trainer and
the sharded upsampler need, each built from ``all_reduce`` and
``broadcast`` alone: the collectives both ``nccl`` and ``gloo`` (also on
CUDA tensors) implement.

There is no fallback: the backend is the one asked for, a CUDA device is
never swapped for the CPU, and a group that cannot start raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from puflow_torch.utils.device import resolve_device

BACKENDS = ("nccl", "gloo")
_RUNNING: list = []          # the group `init_group` started, until destroyed


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in a data-parallel group: its ``rank`` of
    ``world_size``, the ``device`` it computes on and the ``backend`` of
    its collectives (over the default process group)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def is_writer(self) -> bool:
        """Whether this rank prints and writes files (rank 0)."""
        return self.rank == 0


def is_distributed(group: Group | None) -> bool:
    """Whether ``group`` spans more than one rank. A group of one rank
    computes exactly what one process without a group does."""
    return group is not None and group.world_size > 1


def _env_int(name: str, given):
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise RuntimeError(
            f"init_group: {name} is neither given nor in the environment "
            "(start the program under torchrun, or pass rank and "
            "world_size)")
    return int(os.environ[name])


def init_group(backend: str | None = None, rank: int | None = None,
               world_size: int | None = None, device=None,
               init_method: str = "env://",
               timeout_s: float = 600.0) -> Group:
    """Start the default process group and return this rank's `Group`.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``; ``device`` to ``cuda:LOCAL_RANK`` (``LOCAL_RANK``
    defaulting to the rank), made the current CUDA device so that every
    kernel launch of this process goes to it; ``backend`` to ``nccl`` on
    CUDA and ``gloo`` on the CPU. ``init_method`` is the rendezvous
    (``env://`` reads torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``;
    ``file:///path`` needs no port). Raises if CUDA is asked for and
    absent, and if ``nccl`` is asked for on the CPU.
    """
    if device is None:
        local = os.environ.get("LOCAL_RANK",
                               rank if rank is not None
                               else os.environ.get("RANK", 0))
        device = f"cuda:{int(local)}"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device, not {device}")
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _RUNNING[:] = [Group(rank, world_size, device, backend)]
    return _RUNNING[0]


def default_group() -> Group:
    """The group `init_group` started in this process, or else a new one
    with `init_group`'s defaults (torchrun's environment, the card)."""
    return _RUNNING[0] if _RUNNING else init_group()


def destroy_group() -> None:
    """End the default process group, if one is running."""
    _RUNNING.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(x, group: Group | None):
    """This rank's rows ``[r * B / W, (r + 1) * B / W)`` of a global batch
    (a numpy array or a tensor; the whole batch without a group). Raises
    unless ``W`` divides ``B``, as a JAX batch sharding requires."""
    if group is None:
        return x
    B, W = x.shape[0], group.world_size
    if B % W:
        raise ValueError(f"a batch of {B} does not split over {W} ranks")
    b = B // W
    return x[group.rank * b:(group.rank + 1) * b]


def all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the ranks, in place (no autograd); returns it."""
    dist.all_reduce(x)
    return x


def broadcast_(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Every rank's ``x`` set to rank ``src``'s, in place; returns it."""
    dist.broadcast(x, src)
    return x


class _AllReduceSum(torch.autograd.Function):
    """``y = sum over ranks of x``, on every rank. Each rank's loss term
    depends on every rank's ``x`` through ``y``, so the gradient of ``x``
    is the sum over ranks of the gradients ``y`` got: the backward
    all-reduces them, as `torch.nn.SyncBatchNorm`'s does."""

    @staticmethod
    def forward(ctx, x):
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the ranks, differentiably (see `_AllReduceSum`)."""
    return _AllReduceSum.apply(x)


def gather_batch(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The inverse of `shard_batch`: every rank's rows in rank order, on
    every rank, as one all-reduce of a zero-filled global tensor (adding
    zeros changes no value)."""
    b = x.shape[0]
    full = x.new_zeros((b * group.world_size, *x.shape[1:]))
    full[group.rank * b:(group.rank + 1) * b] = x
    dist.all_reduce(full)
    return full


def rank_order_sum(x: torch.Tensor, group: Group,
                   differentiable: bool = False) -> torch.Tensor:
    """The sum over the ranks of ``x``, added in rank order: the same bits
    on every rank. `gather_batch` hands every rank every rank's ``x``
    exactly, and each rank then adds them alike; a plain ``all_reduce``
    does not promise one order of its additions on every rank, and a
    dopri5 decision taken from such a sum could differ between ranks.
    ``differentiable``: the zero-filled global tensor is built by
    concatenation and summed through `all_reduce_sum`, so that gradients
    reach every rank's ``x`` (the masked dopri5 loop's error norm)."""
    if differentiable:
        r, w = group.rank, group.world_size
        parts = all_reduce_sum(torch.cat([
            x.new_zeros((r, *x.shape)), x.reshape(1, *x.shape),
            x.new_zeros((w - r - 1, *x.shape))]))
    else:
        parts = gather_batch(x.reshape(1, *x.shape), group)
    total = parts[0]
    for w in range(1, group.world_size):
        total = total + parts[w]
    return total
