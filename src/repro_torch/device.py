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


_CARDS: dict[int, str] = {}


def card_identity(device) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``): what a measured decision is
    keyed on, since a card set below its limit runs slower.  Without
    ``nvidia-smi`` the limit reads ``unknown``."""
    import subprocess

    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _CARDS:
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--id={index}",
                 "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60, check=True)
            _CARDS[index] = out.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            _CARDS[index] = f"{torch.cuda.get_device_name(index)}, unknown"
    return _CARDS[index]
