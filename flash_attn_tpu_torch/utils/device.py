"""Which device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device. Raises when CUDA is
    wanted (by default or by name) and this machine has none, rather than
    carrying on quietly on the CPU. A bare "cuda" resolves to the current
    card's index, as tensors placed there report it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
