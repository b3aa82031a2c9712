"""Point-cloud file IO (.xyz), numpy-based, host-side."""

from __future__ import annotations

import numpy as np


def load_xyz(path: str) -> np.ndarray:
    """Load an .xyz text file -> [N, C] float32 (C >= 3)."""
    return np.loadtxt(path, dtype=np.float32)


def save_xyz(path: str, points: np.ndarray) -> None:
    """Save points with the reference's '%.6f' format."""
    np.savetxt(path, np.asarray(points), fmt="%.6f")
