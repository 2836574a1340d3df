"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one this raises rather than running
    on the CPU unasked: a caller that wants the CPU says ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "genie_tpu_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is unavailable")
        if device.index is None:  # name the card, so devices compare equal
            device = torch.device("cuda", torch.cuda.current_device())
    return device
