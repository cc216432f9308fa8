"""The device rule of the port's entry points: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card,
    ``torch.device("cuda")``. Raises ``RuntimeError`` when that is asked
    for, by default or by name, and no CUDA device is present: an entry
    point never falls back to the host on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "molann_tpu_torch runs on a CUDA device unless device='cpu' is "
            "passed, and no CUDA device is present "
            "(torch.cuda.is_available() is false)")
    return dev
