"""Where the port's entry points run: on the CUDA card unless the caller
asks for another device."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` means the CUDA card. A CUDA device raises when no card is
    visible: the port never falls back to the CPU on its own; pass
    ``device="cpu"`` for that."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible; pass device='cpu' to run on the CPU"
        )
    return dev
