"""Where the port's tensors go when the caller names no device."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device needs one to be present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
