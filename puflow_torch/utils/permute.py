"""Point-order serialisation research utilities (numpy, host-side).

The port's own copy of `puflow_tpu.utils.permute` (numpy only), with the
folding mode bound to the port's FoldingNet (`utils.folding`):

  * `permute_by_grid` — voxel-serialise a cloud (32^3 grid for 3-D) and
    order occupied cells by 'distance' (from the x-min cell) or 'nearest'
    (greedy nearest-neighbour chain);
  * `permute_by_matching`/`permute_by_matching2` — order the LR cloud by
    grid serial, then order the HR cloud by each LR point's k nearest HR
    points (the `2` variant also returns the LR indices);
  * `permute_by_folding` — order points by their nearest folding-net
    reference point;
  * `lr_hr_matching` — plain k-NN index table LR -> HR;
  * `PermutateHelper` — mode-holding wrapper (grid + folding).

These run at dataset-preparation time; numpy is the right tool (dynamic
shapes: the number of occupied cells is data-dependent). Folding
parameters persist as a flat `.npz` (keys `group.index.name`) that both
packages read and write.
"""

from __future__ import annotations

import numpy as np
import torch

from puflow_torch.checkpoint import _map_tree
from puflow_torch.utils.device import resolve_device
from puflow_torch.utils.folding import folding_net_apply


def _distance_ascending(centers: np.ndarray, start: int) -> np.ndarray:
    d = ((centers - centers[start]) ** 2).sum(-1)
    return np.argsort(d, kind="stable")


def _nearest_ascending(centers: np.ndarray, start: int) -> np.ndarray:
    """Greedy nearest-neighbour chain over cell centres."""
    n = len(centers)
    remaining = np.ones(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    cur = start
    for i in range(n):
        order[i] = cur
        remaining[cur] = False
        if i == n - 1:
            break
        d = ((centers - centers[cur]) ** 2).sum(-1)
        d[~remaining] = np.inf
        cur = int(np.argmin(d))
    return order


def permute_by_grid(pts: np.ndarray, grid_permute: str = "distance",
                    n_grid: int | None = None,
                    is_return_idx: bool = False):
    """Serialise each cloud's point order by voxel-grid traversal.

    pts: [B, N, 3] in [-0.5, 0.5] (or [B, N, 2] in [-1, 1] for image grids).
    """
    B, N, C = pts.shape
    if C == 3:
        gs = 32 if n_grid is None else n_grid
        assert pts.min() >= -0.5 - 1e-6 and pts.max() <= 0.5 + 1e-6
        cell = np.clip(np.floor((pts + 0.5) * gs), 0, gs).astype(np.int64)
        idx_grid = cell[:, :, 2] * gs * gs + cell[:, :, 1] * gs + cell[:, :, 0]
    else:
        gs = 28 if n_grid is None else n_grid
        cell = np.clip(np.floor((pts + 1.0) / 2.0 * gs), 0,
                       gs).astype(np.int64)
        idx_grid = cell[:, :, 1] * gs + cell[:, :, 0]

    order_fn = {"distance": _distance_ascending,
                "nearest": _nearest_ascending}[grid_permute]

    out_idx = np.empty((B, N), dtype=np.int64)
    for b in range(B):
        occupied = np.unique(idx_grid[b])
        x = (occupied % gs).astype(np.float64)
        y = (occupied // gs % gs).astype(np.float64)
        z = (occupied // (gs * gs)).astype(np.float64)
        centers = np.stack([x + 0.5, y + 0.5, z + 0.5], axis=-1)[:, :C]
        start = int(np.argmin(centers[:, 0]))
        cell_order = occupied[order_fn(centers, start)]

        # rank of each point's cell in the traversal, stable within a cell
        rank = np.empty(occupied.max() + 1, dtype=np.int64)
        rank[cell_order] = np.arange(len(cell_order))
        out_idx[b] = np.argsort(rank[idx_grid[b]], kind="stable")

    if is_return_idx:
        return out_idx
    return np.take_along_axis(pts, out_idx[:, :, None], axis=1)


def lr_hr_matching(lr: np.ndarray, sr: np.ndarray, k: int) -> np.ndarray:
    """k nearest HR indices per LR point, ascending distance -> [B, N1, k]."""
    d = ((lr[:, :, None, :] - sr[:, None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=-1, kind="stable")[..., :k]


def permute_by_matching(lr: np.ndarray, sr: np.ndarray, k: int,
                        n_grid: int = 3, is_return_idx: bool = False):
    """Grid-serialise LR, then order HR by each LR point's k-NN
    (reference `permutebymatching`, `:155-181`)."""
    B, N1, _ = lr.shape
    lr_s = permute_by_grid(lr * 0.5, "nearest", n_grid=n_grid) * 2.0
    nearest = lr_hr_matching(lr_s, sr, k)                 # [B, N1, k]
    flat = nearest.reshape(B, N1 * k)
    new_sr = np.take_along_axis(sr, flat[:, :, None], axis=1)
    if is_return_idx:
        d = ((lr_s[:, :, None, :] - sr[:, None, :, :]) ** 2).sum(-1)
        return lr_s, new_sr, np.argsort(d, axis=-1, kind="stable")
    return lr_s, new_sr


def permute_by_matching2(lr: np.ndarray, sr: np.ndarray, k: int,
                         n_grid: int = 3, is_return_idx: bool = False):
    """Like `permute_by_matching`, but also return the LR permute indices
    (reference `permutebymatching2`, `:185-208`)."""
    B, N1, _ = lr.shape
    idx_lr = permute_by_grid(lr * 0.5, "nearest", n_grid=n_grid,
                             is_return_idx=True)          # [B, N1]
    lr_s = np.take_along_axis(lr * 0.5, idx_lr[:, :, None], axis=1) * 2.0
    nearest = lr_hr_matching(lr_s, sr, k)                 # [B, N1, k]
    flat = nearest.reshape(B, N1 * k)
    new_sr = np.take_along_axis(sr, flat[:, :, None], axis=1)
    if is_return_idx:
        d = ((lr_s[:, :, None, :] - sr[:, None, :, :]) ** 2).sum(-1)
        return lr_s, idx_lr, new_sr, np.argsort(d, axis=-1, kind="stable")
    return lr_s, idx_lr, new_sr


def bind_folding(params):
    """`folding_net_apply` on ``params`` (tensors of one device) as a
    numpy -> numpy function for `permute_by_folding`."""
    device = next(iter(params.values()))[0]["w"].device

    def fn(pts):
        x = torch.as_tensor(np.asarray(pts, np.float32), device=device)
        with torch.no_grad():
            return folding_net_apply(params, x).cpu().numpy()

    return fn


def permute_by_folding(pts: np.ndarray, folding_fn) -> np.ndarray:
    """Order each cloud's points by their nearest folding-net reference
    point's index (reference `permutebyfolding`, `:132-151`).

    `folding_fn(pts [B, N, C]) -> reference pts [B, N2, C]` (numpy in,
    array-like out) in canonical order, e.g. `bind_folding(params)`.
    Reproduces the reference's exact index algebra:
    `sorted_idx` is the INVERSE of argsort(nearest_idx), and the gather
    uses the inverse (`:147-151`)."""
    pts = np.asarray(pts)
    ref = np.asarray(folding_fn(pts))                     # [B, N2, C]
    B, N, _ = pts.shape
    d = ((pts[:, :, None, :] - ref[:, None, :, :]) ** 2).sum(-1)
    nearest_idx = np.argmin(d, axis=-1)                   # [B, N]
    sorted_order = np.argsort(nearest_idx, axis=1, kind="stable")
    sorted_idx = np.empty_like(sorted_order)
    np.put_along_axis(sorted_idx, sorted_order,
                      np.broadcast_to(np.arange(N), (B, N)), axis=1)
    return np.take_along_axis(pts, sorted_idx[:, :, None], axis=1)


class PermutateHelper:
    """Mode-holding wrapper (reference `:218-246`)."""

    def __init__(self):
        self.mode = None
        self.grid_permute = "distance"
        self.n_grid = 32
        self.folding_fn = None

    def permutebygrid(self, methods: str, n_grid: int):
        assert methods in ("distance", "nearest")
        self.mode = "grid"
        self.grid_permute = methods
        self.n_grid = n_grid

    def permutebyfolding(self, folding, device="cuda"):
        """`folding` is either a callable numpy pts -> reference pts, or
        a path to an `.npz` of `utils.folding` params, which then run on
        ``device``."""
        self.mode = "folding"
        if callable(folding):
            self.folding_fn = folding
        else:
            device = resolve_device(device)
            with np.load(folding, allow_pickle=False) as loaded:
                params = _map_tree(
                    lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device),
                    _unflatten_npz(loaded))
            self.folding_fn = bind_folding(params)

    def permute(self, pts: np.ndarray, scale: float = 0.5) -> np.ndarray:
        if self.mode is None:
            return pts
        if self.mode == "grid":
            out = permute_by_grid(pts * scale, self.grid_permute,
                                  n_grid=self.n_grid)
            return out * (1.0 / scale)
        return permute_by_folding(pts, self.folding_fn)


def save_folding_params(path: str, params) -> None:
    """Persist `utils.folding` params as a flat .npz (keys
    `group.index.name`), loadable by `PermutateHelper.permutebyfolding`."""
    flat = {}
    for group, layers in params.items():
        for i, layer in enumerate(layers):
            for name, arr in layer.items():
                if isinstance(arr, torch.Tensor):
                    arr = arr.detach().cpu().numpy()
                flat[f"{group}.{i}.{name}"] = np.asarray(arr)
    np.savez(path, **flat)


def _unflatten_npz(loaded) -> dict:
    params: dict = {}
    for key in loaded.files:
        group, idx, name = key.split(".")
        params.setdefault(group, {}).setdefault(int(idx), {})[name] = \
            loaded[key]
    return {g: [layers[i] for i in sorted(layers)]
            for g, layers in params.items()}
