"""Disk-density uniformity measure (parity with `evaluate.py:108-165`).

Consumes the side-files the P2F tool family emits per prediction:
  * ``<pred>_disk_idx.txt``   — "density:idx list" lines, sample_number x
    rad_number rows
  * ``<pred>_radius.txt``     — one radius per percentage
  * ``<pred>_point2mesh_distance.txt`` — per-point records whose columns
    4: are the mapped points

For each disk: coverage = (density - expected)^2 / expected; inner
uniformity = mean((nn_dist - hex_expected)^2 / hex_expected); measure =
mean(coverage * inner) over sampled disks.

The port's copy of `puflow_tpu.eval.uniformity` (numpy only).
"""

from __future__ import annotations

import math
import re

import numpy as np

PERCENTAGES = np.array([0.004, 0.006, 0.008, 0.010, 0.012])


def _nn_distance_excl_self(points: np.ndarray) -> np.ndarray:
    """Distance to the nearest *other* point, for each point."""
    d = np.sqrt(((points[:, None, :] - points[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    return d.min(axis=1)


def analyze_uniform(idx_file: str, radius_file: str,
                    map_points_file: str,
                    sample_number: int | None = None) -> np.ndarray:
    points = np.loadtxt(map_points_file)[:, 4:]
    radius = np.atleast_1d(np.loadtxt(radius_file))
    with open(idx_file) as f:
        lines = f.readlines()

    rad_number = radius.shape[0]
    if sample_number is None:  # infer from the side-file (reference: 1000)
        sample_number = len(lines) // rad_number
    measure = np.zeros([rad_number, 1])
    expect_number = (PERCENTAGES[:rad_number] * points.shape[0]).reshape(
        rad_number, 1)

    for j in range(rad_number):
        uniform_dis = []
        for i in range(sample_number):
            density, idx_str = lines[i * rad_number + j].split(":")
            density = int(density)
            coverage = (density - expect_number[j]) ** 2 / expect_number[j]
            idx = list(map(int, re.findall(r"(\d+)", idx_str)))
            if len(idx) < 5:
                continue
            disk = points[np.asarray(idx, dtype=np.int64)]
            shortest = _nn_distance_excl_self(disk)
            disk_area = math.pi * (radius[j] ** 2) / disk.shape[0]
            expect_d = math.sqrt(2 * disk_area / 1.732)  # hexagon packing
            dis = (shortest - expect_d) ** 2 / expect_d
            uniform_dis.append(float(coverage) * float(np.mean(dis)))
        measure[j, 0] = np.mean(np.asarray(uniform_dis, dtype=np.float32))
    return measure
