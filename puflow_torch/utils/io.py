"""Point-cloud file IO (.xyz / .off), numpy-based, host-side."""

from __future__ import annotations

import numpy as np


def load_xyz(path: str) -> np.ndarray:
    """Load an .xyz text file -> [N, C] float32 (C >= 3)."""
    return np.loadtxt(path, dtype=np.float32)


def save_xyz(path: str, points: np.ndarray) -> None:
    """Save points with the reference's '%.6f' format."""
    np.savetxt(path, np.asarray(points), fmt="%.6f")


def load_off(path: str):
    """Load an OFF mesh -> (vertices [V, 3] float64, faces [F, 3] int64).

    Handles the common OFF layout (counts on the line after the magic, or on
    the same line) and polygonal faces (fan-triangulated).
    """
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0].startswith("OFF"):
        rest = tokens[0][3:]
        tokens = ([rest] if rest else []) + tokens[1:]
    nv, nf = int(tokens[0]), int(tokens[1])
    ptr = 3  # skip edge count
    verts = np.array(tokens[ptr: ptr + nv * 3], dtype=np.float64)
    verts = verts.reshape(nv, 3)
    ptr += nv * 3
    faces = []
    for _ in range(nf):
        k = int(tokens[ptr])
        poly = [int(t) for t in tokens[ptr + 1: ptr + 1 + k]]
        ptr += 1 + k
        for i in range(1, k - 1):  # fan triangulation
            faces.append([poly[0], poly[i], poly[i + 1]])
    return verts, np.array(faces, dtype=np.int64)
