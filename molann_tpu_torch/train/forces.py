"""Coordinate gradients / forces for biased MD: ``torch.autograd.grad``
through the whole align+feature+MLP stack — the eager oracle the fused
cv+forces kernel is held against (port of ``molann_tpu/train/forces.py``).
"""

from __future__ import annotations

import torch

__all__ = ["coordinate_gradients", "force_fn"]


def coordinate_gradients(model, x, component: int | None = None):
    """``∂(Σ_frames out[, component])/∂x`` — per-frame coordinate gradients.

    x: ``[l, n, 3]``. Returns ``[l, n, 3]`` (frames are independent, so the
    batch-summed gradient IS the per-frame gradient).
    """
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        out = model(xx)
        if component is not None:
            out = out[:, component]
        (g,) = torch.autograd.grad(out.sum(), xx)
    return g


def force_fn(model, component: int = 0):
    """``x -> -∂out[:, component]/∂x`` (biasing-force convention)."""

    def forces(x):
        return -coordinate_gradients(model, x, component)

    return forces
