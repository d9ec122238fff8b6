"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    ``None`` means ``cuda``: the port runs on the card unless the caller
    asks for the CPU by name.  A CUDA request with no CUDA device raises
    rather than dropping silently to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def check_on(device: torch.device, **tensors) -> None:
    """Raise unless every given tensor lies on ``device``'s type."""
    for name, t in tensors.items():
        if t is not None and t.device.type != device.type:
            raise ValueError(
                f"{name} lies on {t.device}, expected {device.type}; move "
                f"it with .to() or pass device={t.device.type!r}")
