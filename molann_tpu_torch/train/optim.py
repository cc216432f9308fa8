"""optax's update rules, learning-rate schedules and global-norm clipping in
``torch.optim`` form, to optax's formulas (optax 0.2.6), for the ``train``
command's flags (``molann_tpu/cli/train.py:16-43``).

- :class:`Adam`, :class:`AdamW` and :class:`SGD` are ``torch.optim``'s own
  updates, which equal ``optax.adam``, ``optax.adamw`` (decoupled decay,
  multiplied by the learning rate) and ``optax.sgd`` (heavy-ball momentum
  whose trace starts at the first gradient).
- :class:`RMSprop` is optax's, not torch's: decay 0.9, ``eps`` inside the
  square root, the average starting at 0.
- Each takes ``schedule(count) -> lr``, evaluated at the number of updates
  made before the current one (so the first update uses ``schedule(0)``),
  and ``max_norm``, optax's ``clip_by_global_norm``: the gradients are
  scaled by ``max_norm / ‖g‖`` when ``‖g‖ >= max_norm``, with no term
  added to the norm (``torch.nn.utils.clip_grad_norm_`` adds 1e-6).
- The count is every tensor's ``"step"`` state, so it is saved with the
  optimizer's state and a resumed run repeats the uninterrupted one; the
  groups' ``lr`` stays the base rate between steps.

Schedules (:func:`cosine_decay_schedule`, :func:`warmup_cosine_decay_schedule`,
:func:`exponential_decay`) are optax's, as functions of the count.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "Adam",
    "AdamW",
    "SGD",
    "RMSprop",
    "cosine_decay_schedule",
    "warmup_cosine_decay_schedule",
    "exponential_decay",
]


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """``optax.cosine_decay_schedule``: ``init·((1−α)·½(1+cos(π·t/T)) + α)``
    with ``t`` held at ``T`` past the end."""
    if not decay_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got"
            f" decay_steps={decay_steps}.")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _linear_schedule(init_value, end_value, transition_steps):
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0):
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` over the remaining ``decay_steps - warmup_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = _linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha=alpha)

    def schedule(count):
        return warmup(count) if count < warmup_steps else decay(
            count - warmup_steps)

    return schedule


def exponential_decay(init_value, transition_steps, decay_rate):
    """``optax.exponential_decay`` (continuous, from step 0):
    ``init·rate^(t/transition_steps)``."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value

    def schedule(count):
        if count <= 0:
            return init_value
        return init_value * decay_rate ** (count / transition_steps)

    return schedule


class _OptaxForm:
    """The schedule, the clip and the count around an update rule's
    ``step``. ``_counts_steps``: the rule keeps the ``"step"`` state
    itself (torch's Adam and AdamW do)."""

    _counts_steps = False

    def __init__(self, params, lr, *, schedule=None, max_norm=0.0, **kwargs):
        super().__init__(params, lr=lr, **kwargs)
        self.schedule = schedule
        self.max_norm = float(max_norm)

    def _tensors(self):
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closures are not supported")
        tensors = self._tensors()
        # optax updates every leaf it is given; a tensor the loss did not
        # reach has a zero gradient, not none
        for p in tensors:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        first = self.state[tensors[0]]
        count = int(first["step"]) if "step" in first else 0
        if self.max_norm:
            norm = torch.sqrt(sum(torch.sum(p.grad * p.grad)
                                  for p in tensors))
            for p in tensors:
                p.grad.copy_(torch.where(norm < self.max_norm, p.grad,
                                         p.grad / norm * self.max_norm))
        base = [group["lr"] for group in self.param_groups]
        if self.schedule is not None:
            for group in self.param_groups:
                group["lr"] = float(self.schedule(count))
        try:
            super().step()
        finally:
            for group, lr in zip(self.param_groups, base):
                group["lr"] = lr
        if not self._counts_steps:
            for p in tensors:
                self.state[p]["step"] = torch.tensor(float(count + 1))


class Adam(_OptaxForm, torch.optim.Adam):
    """``optax.adam(schedule)``, optionally after
    ``clip_by_global_norm(max_norm)``."""

    _counts_steps = True


class AdamW(_OptaxForm, torch.optim.AdamW):
    """``optax.adamw(schedule, weight_decay=...)``: the decay is decoupled
    and multiplied by the scheduled learning rate."""

    _counts_steps = True


class SGD(_OptaxForm, torch.optim.SGD):
    """``optax.sgd(schedule, momentum=...)``."""


class _RMSpropRule(torch.optim.Optimizer):
    """optax's ``scale_by_rms`` then the learning rate:
    ``nu = decay·nu + (1−decay)·g²`` from ``nu = 0``,
    ``p −= lr · g / sqrt(nu + eps)``."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                g = p.grad
                nu.copy_((1 - group["decay"]) * (g * g) + group["decay"] * nu)
                p.sub_(group["lr"] * (g * torch.rsqrt(nu + group["eps"])))


class RMSprop(_OptaxForm, _RMSpropRule):
    """``optax.rmsprop(schedule)`` (decay 0.9, ``eps`` 1e-8 inside the
    square root, initial scale 0)."""
