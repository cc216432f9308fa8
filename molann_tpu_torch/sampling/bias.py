"""CV-space biases driven by a MolANN model's coordinate gradients (the
port of ``molann_tpu/sampling/bias.py``).

The downstream-consumer side of the reference's contract: a trained CV
model is differentiated with respect to atomic coordinates, and the chain
rule turns a bias potential in CV space into forces on atoms. Autograd
composes the chain, so a bias is an extra energy term ``V(cv_model(x))``
handed to the integrator. With ``cv_model = lambda x:
fused_model_forward(model, x)`` on the card, each step runs the forward
kernel and, for the force, the backward kernel (K1 and K2, or K6 and K7
for a blocked model).

Two biases:

- :func:`steered_langevin` — a harmonic restraint whose center walks
  linearly from ``s0`` to ``s1`` in CV space (steered MD).
- :func:`metadynamics_langevin` — multiple-walker metadynamics: every
  ``stride`` steps each walker deposits a Gaussian at its current CV;
  the accumulated :class:`MetadBias` pushes walkers out of visited
  basins.

Deposits are index writes into a center buffer sized up front; periods
are a Python loop over device tensors, with no read back to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import langevin as _lv

__all__ = ["MetadBias", "steered_langevin", "metadynamics_langevin"]


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class MetadBias:
    """Accumulated metadynamics bias: Gaussians of ``height`` (scaled by
    per-deposit ``weights`` in the well-tempered variant) and width
    ``sigma`` at ``centers [k, d]`` in CV space. ``energy(cv [W, d]) ->
    [W]``, evaluated on the device of ``cv``."""

    def __init__(self, centers, height, sigma, n_active=None,
                 weights=None, gamma=None):
        self.centers = (centers.detach().to(torch.float32)
                        if isinstance(centers, torch.Tensor)
                        else torch.as_tensor(np.asarray(centers, np.float32)))
        self.height = float(height)
        self.sigma = float(sigma)
        k = self.centers.shape[0]
        self.n_active = k if n_active is None else n_active
        self.weights = (
            torch.ones((k,), dtype=torch.float32, device=self.centers.device)
            if weights is None
            else _lv._tensor(weights, like=self.centers).detach()
        )
        self.gamma = gamma  # well-tempered bias factor (None = standard)

    def to(self, device):
        """Move the stored tensors to ``device`` (returns self), so that
        evaluations there copy nothing."""
        for name in ("centers", "weights"):
            setattr(self, name, getattr(self, name).to(device))
        return self

    def energy(self, cv):
        cv = _lv._tensor(cv, like=self.centers)
        centers = self.centers.to(cv.device)
        weights = self.weights.to(cv.device)
        diff = cv[:, None, :] - centers[None, :, :]
        g = torch.exp(
            -torch.sum(diff * diff, dim=-1) / (2.0 * self.sigma**2)
        )
        mask = (torch.arange(centers.shape[0], device=cv.device)
                < self.n_active).to(cv.dtype)
        return self.height * torch.sum(g * (mask * weights)[None, :], dim=-1)

    def free_energy_estimate(self, grid):
        """Free energy on a ``[m, d]`` grid of CV points (up to a
        constant): ``-V(s)`` for standard metadynamics, scaled by
        ``gamma/(gamma-1)`` in the well-tempered variant (the standard
        WTMetaD estimator)."""
        v = self.energy(grid)
        if self.gamma is not None:
            return -(self.gamma / (self.gamma - 1.0)) * v
        return -v

    def frame_weights(self, cv, kT):
        """Per-frame reweighting factors ``w_t ∝ exp(+V_b(s_t)/kT)``
        for recovering UNBIASED averages from a biased trajectory under
        the final (quasi-static) bias — the standard last-bias WTMetaD
        estimator. Returns weights normalized to mean 1 over the input
        (so ``mean(w * f(s))`` estimates the unbiased ``<f>``),
        numerically stabilized by subtracting the max exponent. Feed them
        into the ``weights=`` argument of the training losses."""
        v = self.energy(cv) / float(kT)
        w = torch.exp(v - torch.max(v))
        return w / torch.mean(w)

    def save(self, path):
        """Write the hills to ``path`` (.npz, the JAX package's keys).
        Well-tempered runs carry per-deposit ``weights`` + ``gamma``;
        standard runs stay in the weight-free format. Only the active
        deposits are written."""
        k = int(self.n_active)
        extra = {}
        if self.gamma is not None:
            extra = dict(weights=_host(self.weights[:k]), gamma=self.gamma)
        np.savez(path, centers=_host(self.centers[:k]),
                 height=self.height, sigma=self.sigma, **extra)

    @classmethod
    def load(cls, path):
        """Rebuild a :class:`MetadBias` from a hills ``.npz`` written by
        :meth:`save` (or ``sample --bias-out``), either package's."""
        with np.load(path) as f:
            return cls(
                f["centers"], float(f["height"]), float(f["sigma"]),
                weights=f["weights"] if "weights" in f else None,
                gamma=float(f["gamma"]) if "gamma" in f else None,
            )


def steered_langevin(energy_fn, cv_model, x0, *, s0, s1, k_spring,
                     n_steps, dt, kT, generator, thin=10):
    """Steered MD: pull the model's CV from ``s0`` to ``s1`` with a
    moving harmonic restraint (piecewise-constant within each ``thin``
    window).

    cv_model: ``[W, n, 3] -> [W, d]`` (a model, or e.g. ``lambda x:
    fused_model_forward(model, x)``). generator: ``torch.Generator`` on the
    walkers' device. Returns ``(traj [n_steps//thin, W, n, 3], x_final)``.
    """
    if n_steps % thin:
        raise ValueError("n_steps must be a multiple of thin")
    n_periods = n_steps // thin
    x = _lv._tensor(x0)
    _lv._check_generator(generator, x)
    s0 = _lv._tensor(s0, like=x)
    s1 = _lv._tensor(s1, like=x)
    # window p is restrained at the target for that window's END, so the
    # pull covers the full s0->s1 interval
    frac = (torch.arange(1, n_periods + 1, dtype=torch.float32,
                         device=x.device) / float(n_periods))
    schedule = s0[None, :] + frac[:, None] * (s1 - s0)[None, :]

    def total(xx, s):
        bias = 0.5 * k_spring * torch.sum((cv_model(xx) - s[None, :]) ** 2,
                                          dim=-1)
        return torch.sum(energy_fn(xx)) + torch.sum(bias)

    grad = _lv._grad_fn(total)
    noise_scale = math.sqrt(2.0 * float(kT) * float(dt))
    traj = x.new_empty((n_periods,) + tuple(x.shape))
    for p in range(n_periods):
        s = schedule[p]
        for _ in range(thin):
            xi = _lv._normal(x.shape, generator)
            x = x - dt * grad(x, s) + noise_scale * xi
        traj[p] = x
    return traj, x


def metadynamics_langevin(energy_fn, cv_model, x0, *, n_steps, dt, kT,
                          generator, height, sigma, stride,
                          well_tempered_gamma=None):
    """Multiple-walker metadynamics along the model's CV.

    Every ``stride`` steps each of the W walkers deposits one Gaussian
    at its current CV value; all walkers feel all deposits. One period's
    dynamics run with the bias frozen, then the deposit happens.

    well_tempered_gamma: bias factor ``γ > 1`` switches on WELL-TEMPERED
    metadynamics: each deposit is scaled by ``exp(-V(s)/(kT (γ-1)))`` at
    its own location, so hill heights decay as a basin fills. ``None`` =
    standard metadynamics (constant hills).

    The model runs once a step under autograd (its value and, for the
    force, its VJP) and once a period for the deposit, without a graph.

    Returns ``(traj [n_periods, W, n, 3] recorded at period ends,
    x_final, bias)`` where ``bias`` is the accumulated
    :class:`MetadBias` (centers ``[n_periods * W, d]``, per-deposit
    weights in the well-tempered case).
    """
    if n_steps % stride:
        raise ValueError("n_steps must be a multiple of stride")
    if well_tempered_gamma is not None and well_tempered_gamma <= 1.0:
        raise ValueError("well_tempered_gamma must be > 1")
    x = _lv._tensor(x0)
    _lv._check_generator(generator, x)
    n_periods = n_steps // stride
    W = x.shape[0]
    sigma = float(sigma)
    height = float(height)
    # the buffers are sized at the first CV evaluation (d is the model's
    # output width): no call of the model beyond the steps and deposits
    buf = {}

    def buffers(d):
        if not buf:
            buf["centers"] = torch.zeros((n_periods * W, d),
                                         dtype=torch.float32, device=x.device)
            buf["weights"] = torch.zeros((n_periods * W,),
                                         dtype=torch.float32, device=x.device)
        return buf["centers"], buf["weights"]

    def bias_at(cv, centers, weights):
        diff = cv[:, None, :] - centers[None, :, :]
        g = torch.exp(-torch.sum(diff * diff, dim=-1) / (2.0 * sigma**2))
        return height * torch.sum(g * weights[None, :], dim=-1)

    def total(xx):
        cv = cv_model(xx)
        centers, weights = buffers(cv.shape[-1])
        return torch.sum(energy_fn(xx)) + torch.sum(
            bias_at(cv, centers, weights))

    grad = _lv._grad_fn(total)
    noise_scale = math.sqrt(2.0 * float(kT) * float(dt))
    traj = x.new_empty((n_periods,) + tuple(x.shape))
    for p in range(n_periods):
        for _ in range(stride):
            xi = _lv._normal(x.shape, generator)
            x = x - dt * grad(x) + noise_scale * xi
        with torch.no_grad():
            cv = cv_model(x)
            centers, weights = buffers(cv.shape[-1])
            if well_tempered_gamma is None:
                w_new = torch.ones((W,), dtype=torch.float32, device=x.device)
            else:
                w_new = torch.exp(
                    -bias_at(cv, centers, weights)
                    / (kT * (well_tempered_gamma - 1.0)))
            centers[p * W:(p + 1) * W] = cv
            weights[p * W:(p + 1) * W] = w_new
        traj[p] = x
    if not buf:  # no step ran (n_steps = 0): the width from one call
        buffers(cv_model(x[:1]).shape[-1])
    return traj, x, MetadBias(
        buf["centers"], height, sigma, weights=buf["weights"],
        gamma=well_tempered_gamma,
    )
