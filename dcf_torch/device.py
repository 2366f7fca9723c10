"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. Entry points default to
    the card; asking for CUDA without a card raises rather than falling
    back to the CPU, so CPU runs are always asked for (`device="cpu"`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "run the plain PyTorch path on the CPU")
    return device
