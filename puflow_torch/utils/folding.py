"""Minimal trainable FoldingNet for folding-based point-order permutation.

Counterpart of `puflow_tpu.utils.folding`: a small FoldingNet-style
decoder (a PointNet max-pooled global feature, then a 2-layer fold of a
fixed 2-D grid) and a chamfer-fit trainer. `utils.permute` uses it as a
black-box ``pts [B, N, C] -> reference pts [B, n_ref, C]`` generator.

The fold decodes a FIXED 16 x 16 grid, so its output order is the grid's
raster order whatever the input cloud's point order: the property the
permutation scheme relies on.
"""

from __future__ import annotations

import torch

from puflow_torch.ops.chamfer import chamfer_distance
from puflow_torch.utils.device import resolve_device
from puflow_torch.utils.params import count_parameters  # noqa: F401

GRID_SIDE = 16  # n_ref = GRID_SIDE^2 reference points
FEAT_DIM = 64
HIDDEN = 64


def _linear_init(generator, din: int, dout: int, device) -> dict:
    b = (1.0 / din) ** 0.5
    w = torch.rand((din, dout), generator=generator, device=device)
    return {"w": (w * 2.0 - 1.0) * b, "b": torch.zeros((dout,), device=device)}


def _mlp(params, x):
    for i, p in enumerate(params):
        x = x @ p["w"] + p["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def folding_net_init(generator: torch.Generator, pc_channel: int = 3,
                     device="cuda") -> dict:
    """The generator must live on ``device``."""
    device = resolve_device(device)

    def lin(din, dout):
        return _linear_init(generator, din, dout, device)

    return {
        # per-point encoder -> max-pool global feature
        "enc": [lin(pc_channel, HIDDEN), lin(HIDDEN, FEAT_DIM)],
        # fold 1: [grid(2) + feat] -> 3
        "fold1": [lin(2 + FEAT_DIM, HIDDEN), lin(HIDDEN, pc_channel)],
        # fold 2: [fold1(3) + feat] -> 3
        "fold2": [lin(pc_channel + FEAT_DIM, HIDDEN),
                  lin(HIDDEN, pc_channel)],
    }


def _grid(n_side: int = GRID_SIDE, device=None) -> torch.Tensor:
    ax = torch.linspace(-1.0, 1.0, n_side, device=device)
    gx, gy = torch.meshgrid(ax, ax, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def folding_net_apply(params, pts: torch.Tensor) -> torch.Tensor:
    """pts [B, N, C] -> reference points [B, n_ref, C] in canonical
    (grid-raster) order."""
    feat = torch.amax(_mlp(params["enc"], pts), dim=1)          # [B, F]
    grid = _grid(device=pts.device)                             # [G, 2]
    B, G = pts.shape[0], grid.shape[0]
    feat_rep = feat[:, None, :].expand(B, G, feat.shape[-1])
    grid_rep = grid[None].expand(B, G, 2)
    y = _mlp(params["fold1"], torch.cat([grid_rep, feat_rep], dim=-1))
    return _mlp(params["fold2"], torch.cat([y, feat_rep], dim=-1))


def train_folding_net(generator: torch.Generator, clouds, steps: int = 200,
                      lr: float = 1e-3, device="cuda", params=None):
    """Fit the folding net to reconstruct ``clouds`` [B, N, C] by chamfer
    distance, SGD with momentum 0.9 (this is a dataset-prep utility).
    Starts from ``params`` if given, else from `folding_net_init`.
    Returns (trained params, the last step's loss)."""
    device = resolve_device(device)
    if params is None:
        params = folding_net_init(generator, device=device)
    params = {g: [{k: v.detach().clone().to(device).requires_grad_()
                   for k, v in layer.items()} for layer in layers]
              for g, layers in params.items()}
    leaves = [v for layers in params.values() for layer in layers
              for v in layer.values()]
    clouds = torch.as_tensor(clouds, dtype=torch.float32, device=device)
    opt = torch.optim.SGD(leaves, lr=lr, momentum=0.9)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = chamfer_distance(folding_net_apply(params, clouds), clouds)
        loss.backward()
        opt.step()
    params = {g: [{k: v.detach() for k, v in layer.items()}
                  for layer in layers] for g, layers in params.items()}
    return params, float(loss.detach())


def sample_grid_count() -> int:
    return GRID_SIDE * GRID_SIDE
