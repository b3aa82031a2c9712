"""Jensen-Shannon divergence between occupancy grids of point-cloud sets.

Parity target: reference `evaluation/jsd.py` (Achlioptas et al. metric):
28^3 grid cell centres over the unit cube, sphere-clipped; each point
counted in its nearest cell; JSD between the two sets' count
distributions, computed with the base-2 entropy formula (`jsd.py:107-144`).

The port's copy of the path of `puflow_tpu.eval.jsd` that
`jsd_between_point_cloud_sets` takes (numpy only).
"""

from __future__ import annotations

import warnings

import numpy as np


def sphere_grid(resolution: int) -> np.ndarray:
    """Cell centres of a resolution^3 grid over [-0.5, 0.5]^3 that lie in
    the unit sphere."""
    spacing = 1.0 / (resolution - 1)
    axis = np.arange(resolution, dtype=np.float32) * spacing - 0.5
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    return grid[np.linalg.norm(grid, axis=1) <= 0.5]


def occupancy_counters(pclouds: np.ndarray, resolution: int) -> np.ndarray:
    """Points of all clouds per sphere-clipped grid cell, each point in its
    nearest cell (`jsd.py:66-104`, ``in_sphere=True``)."""
    eps = 1e-3
    bound = 0.5 + eps
    if abs(np.max(pclouds)) > bound or abs(np.min(pclouds)) > bound:
        warnings.warn("Point-clouds are not in unit cube.")
    if np.max(np.sqrt(np.sum(pclouds**2, axis=2))) > bound:
        warnings.warn("Point-clouds are not in unit sphere.")

    grid = sphere_grid(resolution)
    counters = np.zeros(len(grid))
    for pc in pclouds:
        # brute force against the (~11K) remaining centres
        d = ((np.asarray(pc, np.float32)[:, None, :] - grid[None]) ** 2
             ).sum(-1)
        np.add.at(counters, np.argmin(d, axis=1), 1)
    return counters


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
    return jensen_shannon_divergence(occupancy_counters(sample_pcs,
                                                        resolution),
                                     occupancy_counters(ref_pcs, resolution))
