"""Jensen-Shannon divergence between occupancy grids of point-cloud sets.

Parity target: reference `evaluation/jsd.py` (Achlioptas et al. metric):
28^3 grid cell centres over the unit cube, sphere-clipped; each point
counted in its nearest cell; JSD between the two sets' count
distributions, computed with the base-2 entropy formula (`jsd.py:107-144`).

The port's copy of `puflow_tpu.eval.jsd` (numpy only).
"""

from __future__ import annotations

import warnings

import numpy as np


def unit_cube_grid(resolution: int, clip_sphere: bool = False):
    """Cell-centre coordinates of a resolution^3 grid over [-0.5, 0.5]^3
    (with ``clip_sphere``, those in the unit sphere), and the spacing."""
    spacing = 1.0 / (resolution - 1)
    axis = np.arange(resolution, dtype=np.float32) * spacing - 0.5
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    if clip_sphere:
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid, spacing


def _nearest_cell_indices(pc: np.ndarray, grid: np.ndarray,
                          resolution: int, clip_sphere: bool) -> np.ndarray:
    """Index (into `grid`) of each point's nearest cell centre."""
    if not clip_sphere:
        spacing = 1.0 / (resolution - 1)
        ijk = np.clip(np.rint((pc + 0.5) / spacing), 0,
                      resolution - 1).astype(np.int64)
        return (ijk[:, 0] * resolution + ijk[:, 1]) * resolution + ijk[:, 2]
    # sphere-clipped grid: brute force against the (~11K) remaining centres
    d = ((pc[:, None, :] - grid[None, :, :]) ** 2).sum(-1)
    return np.argmin(d, axis=1)


def entropy_of_occupancy_grid(pclouds: np.ndarray, resolution: int,
                              in_sphere: bool = False):
    """(mean bernoulli entropy, per-cell point counters) — `jsd.py:66-104`.
    Each cell is a Bernoulli variable: occupied by a cloud or not."""
    eps = 1e-3
    bound = 0.5 + eps
    if abs(np.max(pclouds)) > bound or abs(np.min(pclouds)) > bound:
        warnings.warn("Point-clouds are not in unit cube.")
    if in_sphere and np.max(np.sqrt(np.sum(pclouds**2, axis=2))) > bound:
        warnings.warn("Point-clouds are not in unit sphere.")

    grid, _ = unit_cube_grid(resolution, in_sphere)
    counters = np.zeros(len(grid))
    bernoulli = np.zeros(len(grid))
    for pc in pclouds:
        idx = _nearest_cell_indices(np.asarray(pc, np.float32), grid,
                                    resolution, in_sphere)
        np.add.at(counters, idx, 1)
        bernoulli[np.unique(idx)] += 1

    n = float(len(pclouds))
    p = bernoulli[bernoulli > 0] / n
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -(p * np.log(p) + (1 - p) * np.log(1 - p))
    ent = np.nan_to_num(ent)  # p == 1 -> 0 * log(0) := 0
    return ent.sum() / len(counters), counters


def _entropy_base2(p: np.ndarray) -> float:
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def jensen_shannon_divergence(P: np.ndarray, Q: np.ndarray) -> float:
    if np.any(P < 0) or np.any(Q < 0):
        raise ValueError("Negative values.")
    if len(P) != len(Q):
        raise ValueError("Non equal size.")
    P_ = P / np.sum(P)
    Q_ = Q / np.sum(Q)
    e_sum = _entropy_base2((P_ + Q_) / 2.0)
    return e_sum - (_entropy_base2(P_) + _entropy_base2(Q_)) / 2.0


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs,
                                 resolution: int = 28) -> float:
    """JSD between occupancy statistics of two cloud sets (`jsd.py:54-64`)."""
    sample_counters = entropy_of_occupancy_grid(sample_pcs, resolution,
                                                True)[1]
    ref_counters = entropy_of_occupancy_grid(ref_pcs, resolution, True)[1]
    return jensen_shannon_divergence(sample_counters, ref_counters)
