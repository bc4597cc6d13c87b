"""Device selection: a CUDA request either gets a card or fails."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    no card is visible, so a run never carries on on the CPU unnoticed."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False (no GPU visible, or PyTorch built without CUDA)")
    return device
