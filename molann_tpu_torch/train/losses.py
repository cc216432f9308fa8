"""Losses for collective-variable training over ``(model, batch)``.

The port of ``mse_loss`` and ``fused_mse_loss``
(``molann_tpu/train/losses.py:31-45``). The other objectives
(autoencoder, eigenfunction, committor) are not ported yet (ROADMAP.md,
queue 2).
"""

from __future__ import annotations

import torch

from ..ops.fused import fused_model_forward

__all__ = ["mse_loss", "fused_mse_loss"]


def mse_loss(model, batch):
    """Supervised regression through the eager model: batch = ``(x [l, n,
    3], y [l, d])`` tensors."""
    x, y = batch
    return torch.mean((model(x) - y) ** 2)


def fused_mse_loss(model, batch, *, interpret=False):
    """:func:`mse_loss` through the fused path: on the card the forward
    kernel, and under autograd the backward kernel (the unrolled or the
    blocked pair, by the system's size). x may be packed ``[l, 3n]``."""
    x, y = batch
    pred = fused_model_forward(model, x, interpret=interpret)
    return torch.mean((pred - y) ** 2)
