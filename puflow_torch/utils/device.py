"""Device selection for the port's public entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a `torch.device`; raises if it names an absent card.

    There is no fallback: asking for CUDA on a host without it is an
    error, never a quiet switch to the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False")
    return device
