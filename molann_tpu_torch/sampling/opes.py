"""OPES: on-the-fly probability enhanced sampling along model CVs (the
port of ``molann_tpu/sampling/opes.py``).

Invernizzi & Parrinello, "Rethinking Metadynamics: From Bias Potentials to
Probability Distributions", JPCL 11, 2731 (2020): OPES keeps a weighted
kernel-density estimate ``P̃(s)`` of the UNBIASED CV probability and
applies the bias

    ``V(s) = (1 - 1/γ) kT · log( P̃(s)/Z + ε )``

which converts ``P`` into the well-tempered target ``P^{1/γ}``; its depth
is capped at ``ΔE`` (``ε = exp(-β ΔE/(1-1/γ))``, the "barrier"). Each
deposited kernel carries the importance weight ``w_k = exp(β V(s_k))`` of
its own sample under the bias at deposit time; ``Z`` is the mean of
``P̃`` over the deposited kernel centers.

Two modes, selected by ``opes_langevin(..., adaptive=)``:

- ``adaptive=False`` (default): fixed bandwidth ``sigma``, one kernel
  appended per walker per period into a buffer sized up front.
- ``adaptive=True``: the PLUMED scheme: new-kernel bandwidth
  ``σ = σ0 [n_eff (d+2)/4]^{-1/(d+4)}`` with ``n_eff = (Σw)²/Σw²``, and a
  kernel landing within ``merge_threshold·σ`` of an existing kernel is
  merged into it moment-preservingly instead of appended. The kernel list
  is a fixed ``max_kernels`` buffer (full: every deposit merges into its
  nearest kernel); the count of kernels stays a tensor on the device,
  read back once, at the end.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import langevin as _lv
from .bias import _host

__all__ = ["OpesBias", "opes_langevin"]

_TINY = 1e-30


def _raw_kde(q, centers, weights, sigmas):
    """Weighted Gaussian KDE ``[m, d] -> [m]`` with per-kernel
    bandwidths ``sigmas [k]``. Each kernel carries the ``σ_k^{-d}``
    normalization; the common ``(2π)^{-d/2}`` factor cancels in every
    ``P̃/Z`` ratio. Empty slots (``σ_k = 0``) are guarded (their weight
    is 0)."""
    d = q.shape[-1]
    s = torch.where(sigmas > 0, sigmas, torch.ones_like(sigmas))
    diff = q[:, None, :] - centers[None, :, :]
    g = torch.exp(-torch.sum(diff * diff, dim=-1) / (2.0 * s**2))
    return torch.sum(g * (weights * s ** (-d))[None, :], dim=-1)


class OpesBias:
    """Accumulated OPES state: kernel ``centers [k, d]`` with importance
    ``weights [k]``, bandwidth ``sigma``, bias factor ``gamma``, and the
    barrier cap ``barrier`` (ΔE) at temperature ``kT``.

    ``energy(cv [W, d]) -> [W]`` is the bias ``V(s)`` — in ``[-ΔE, ~0]``,
    highest where the estimated probability is highest; evaluated on the
    device of ``cv``."""

    def __init__(self, centers, weights, *, sigma, gamma, kT, barrier,
                 n_active=None, sigmas=None):
        self.centers = (centers.detach().to(torch.float32)
                        if isinstance(centers, torch.Tensor)
                        else torch.as_tensor(np.asarray(centers, np.float32)))
        self.weights = _lv._tensor(weights, like=self.centers).detach()
        self.sigma = float(sigma)  # σ0 (deposit-time base bandwidth)
        k = self.centers.shape[0]
        self.sigmas = (torch.full((k,), self.sigma, dtype=torch.float32,
                                  device=self.centers.device)
                       if sigmas is None
                       else _lv._tensor(sigmas, like=self.centers).detach())
        self.gamma = float(gamma)
        self.kT = float(kT)
        self.barrier = float(barrier)
        self.n_active = k if n_active is None else n_active
        if self.gamma <= 1.0:
            raise ValueError("gamma must be > 1")

    def to(self, device):
        """Move the stored tensors to ``device`` (returns self), so that
        evaluations there copy nothing."""
        for name in ("centers", "weights", "sigmas"):
            setattr(self, name, getattr(self, name).to(device))
        return self

    @property
    def _prefactor(self):
        return (1.0 - 1.0 / self.gamma) * self.kT

    @property
    def _epsilon(self):
        return math.exp(-self.barrier / self._prefactor)

    def _on(self, device):
        centers = self.centers.to(device)
        mask = (torch.arange(centers.shape[0], device=device)
                < self.n_active).to(torch.float32)
        return (centers, self.weights.to(device) * mask,
                self.sigmas.to(device), mask)

    def energy(self, cv):
        """``V(s)`` on CV points ``[W, d] -> [W]`` (identically zero
        while the estimator is empty)."""
        cv = _lv._tensor(cv, like=self.centers)
        centers, w, sigmas, mask = self._on(cv.device)
        p = _raw_kde(cv, centers, w, sigmas)
        p_cent = _raw_kde(centers, centers, w, sigmas)
        z = torch.sum(p_cent * mask) / torch.clamp(torch.sum(mask), min=1.0)
        # the untaken branch must be NaN-free in its GRADIENT too, so
        # substitute a safe z before the log, then select
        active = z > 0
        ratio = p / torch.where(active, z, torch.ones_like(z))
        v = self._prefactor * torch.log(ratio + self._epsilon)
        return torch.where(active, v, torch.zeros_like(v))

    def free_energy_estimate(self, grid):
        """Free energy on a ``[m, d]`` grid (up to a constant):
        ``-kT log P̃(s)``, floored at the ΔE cap below the explored
        maximum (max of P̃ over the deposited centers), so the function
        stays smooth and finite (``mep`` differentiates it)."""
        grid = _lv._tensor(grid, like=self.centers)
        centers, w, sigmas, mask = self._on(grid.device)
        p = _raw_kde(grid, centers, w, sigmas)
        p_cent = _raw_kde(centers, centers, w, sigmas)
        pmax = torch.clamp(torch.max(p_cent * mask), min=_TINY)
        floor = pmax * math.exp(-self.barrier / self.kT)
        return -self.kT * torch.log(torch.maximum(p, floor))

    def frame_weights(self, cv, kT=None):
        """Per-frame reweighting factors ``w_t ∝ exp(+V(s_t)/kT)``
        (normalized to mean 1) — same contract as
        :meth:`MetadBias.frame_weights`."""
        kT = self.kT if kT is None else float(kT)
        v = self.energy(cv) / kT
        w = torch.exp(v - torch.max(v))
        return w / torch.mean(w)

    def save(self, path):
        """Write the kernels to ``path`` (.npz, the JAX package's keys).
        Only active kernels are written; the ``opes`` marker field lets
        :func:`molann_tpu_torch.sampling.load_bias` tell OPES from
        metadynamics files."""
        k = int(self.n_active)
        np.savez(path, opes=1, centers=_host(self.centers[:k]),
                 weights=_host(self.weights[:k]), sigma=self.sigma,
                 sigmas=_host(self.sigmas[:k]),
                 gamma=self.gamma, kT=self.kT, barrier=self.barrier)

    @classmethod
    def load(cls, path):
        with np.load(path) as f:
            if "opes" not in f:
                raise ValueError(
                    f"{path} is not an OPES kernels file (use "
                    "MetadBias.load / load_bias for hills files)"
                )
            return cls(
                f["centers"], f["weights"], sigma=float(f["sigma"]),
                sigmas=f["sigmas"] if "sigmas" in f else None,
                gamma=float(f["gamma"]), kT=float(f["kT"]),
                barrier=float(f["barrier"]),
            )


def opes_langevin(energy_fn, cv_model, x0, *, n_steps, dt, kT, generator,
                  sigma, stride, barrier, gamma=None, adaptive=False,
                  max_kernels=None, merge_threshold=1.0):
    """Multiple-walker OPES along the model's CV (same shape as
    :func:`~molann_tpu_torch.sampling.metadynamics_langevin`: ``stride``
    steps per period with the bias frozen, then every walker deposits one
    kernel).

    barrier: ΔE, the expected barrier height (energy units of
    ``energy_fn``) — caps the bias depth. gamma: bias factor; default
    ``ΔE/kT`` (the PLUMED default), targeting ``P^{1/γ}``.
    generator: ``torch.Generator`` on the walkers' device.

    adaptive: the PLUMED bandwidth-shrink + kernel-compression scheme
    (module docstring); new kernels use
    ``σ = σ0 [n_eff (d+2)/4]^{-1/(d+4)}`` (floored at ``σ0/10``) and merge
    into any kernel closer than ``merge_threshold·σ``; the list is bounded
    by ``max_kernels`` slots (default ``min(n_walkers·n_periods, 512)``).

    Returns ``(traj [n_periods, W, n, 3] recorded at period ends,
    x_final, bias)`` with ``bias`` the accumulated :class:`OpesBias`.
    """
    if n_steps % stride:
        raise ValueError("n_steps must be a multiple of stride")
    if barrier <= 0:
        raise ValueError("barrier must be > 0")
    gamma = float(barrier / kT) if gamma is None else float(gamma)
    if gamma <= 1.0:
        raise ValueError(
            f"gamma must be > 1 (got {gamma:g}; barrier/kT too small?)"
        )
    x = _lv._tensor(x0)
    _lv._check_generator(generator, x)
    dev = x.device
    n_periods = n_steps // stride
    W = x.shape[0]
    sigma = float(sigma)
    # the JAX function's float32 constants
    pref = np.float32((1.0 - 1.0 / gamma) * kT)
    eps = float(np.exp(np.float32(-barrier) / pref))
    pref = float(pref)
    if adaptive:
        K = (min(n_periods * W, 512) if max_kernels is None
             else int(max_kernels))
        if K < 1:
            raise ValueError("max_kernels must be >= 1")
    else:
        K = n_periods * W
    slot_idx = torch.arange(K, device=dev)
    # the buffers are sized at the first CV evaluation (d is the model's
    # output width): no call of the model beyond the steps and deposits
    buf = {}

    def buffers(d):
        if not buf:
            buf["centers"] = torch.zeros((K, d), dtype=torch.float32,
                                         device=dev)
            buf["weights"] = torch.zeros((K,), dtype=torch.float32,
                                         device=dev)
            buf["sigmas"] = (torch.zeros((K,), dtype=torch.float32,
                                         device=dev) if adaptive
                             else torch.full((K,), sigma, dtype=torch.float32,
                                             device=dev))
        return buf["centers"], buf["weights"], buf["sigmas"]

    def bias_at(cv, centers, weights, sigmas, z):
        # z <= 0 marks an empty estimator: no bias yet. The safe-z
        # substitution keeps the untaken branch NaN-free in the GRADIENT
        p = _raw_kde(cv, centers, weights, sigmas)
        active = z > 0
        v = pref * torch.log(p / torch.where(active, z, torch.ones_like(z))
                             + eps)
        return torch.where(active, v, torch.zeros_like(v))

    def explored_z(centers, weights, sigmas, mask):
        # mean of P̃ over the deposited kernel centers (the explored set)
        p_cent = _raw_kde(centers, centers, weights, sigmas)
        return torch.sum(p_cent * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)

    def total(xx, z):
        cv = cv_model(xx)
        centers, weights, sigmas = buffers(cv.shape[-1])
        return torch.sum(energy_fn(xx)) + torch.sum(
            bias_at(cv, centers, weights, sigmas, z))

    grad = _lv._grad_fn(total)
    noise_scale = math.sqrt(2.0 * float(kT) * float(dt))
    traj = x.new_empty((n_periods,) + tuple(x.shape))
    count = torch.zeros((), dtype=torch.int64, device=dev)
    sigma_min = sigma / 10.0
    for p in range(n_periods):
        if buf:
            centers, weights, sigmas = buffers(None)
            mask = ((slot_idx < p * W) if not adaptive
                    else (slot_idx < count)).to(torch.float32)
            # Z is a function of the frozen kernel set: once a period
            z = explored_z(centers, weights * mask, sigmas, mask)
        else:  # nothing deposited: the empty estimator's Z is 0
            z = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(stride):
            xi = _lv._normal(x.shape, generator)
            x = x - dt * grad(x, z) + noise_scale * xi
        with torch.no_grad():
            cv = cv_model(x)
            centers, weights, sigmas = buffers(cv.shape[-1])
            if not adaptive:
                # the kernel's importance weight = exp(+beta V) at the
                # deposit point, under the bias the sample was drawn with
                w_new = torch.exp(bias_at(cv, centers, weights, sigmas, z)
                                  / kT)
                centers[p * W:(p + 1) * W] = cv
                weights[p * W:(p + 1) * W] = w_new
            else:
                _adaptive_deposit(cv, centers, weights, sigmas, count, z,
                                  bias_at, kT, sigma, sigma_min,
                                  merge_threshold, slot_idx)
        traj[p] = x
    if not buf:  # no step ran (n_steps = 0): the width from one call
        buffers(cv_model(x[:1]).shape[-1])
    centers, weights, sigmas = buffers(None)
    if not adaptive:
        return traj, x, OpesBias(
            centers, weights, sigma=sigma, gamma=gamma, kT=kT,
            barrier=barrier,
        )
    return traj, x, OpesBias(
        centers, weights, sigma=sigma, sigmas=sigmas, gamma=gamma,
        kT=kT, barrier=barrier, n_active=int(count),
    )


def _adaptive_deposit(cv, centers, weights, sigmas, count, z, bias_at, kT,
                      sigma, sigma_min, merge_threshold, slot_idx):
    """One period's deposits of the adaptive scheme, in walker order, in
    place (``count`` too): the shrunk bandwidth from the effective sample
    size of everything deposited so far (this period's walkers included),
    then merge-or-append per walker."""
    W, d = cv.shape
    K = centers.shape[0]
    mask = (slot_idx < count).to(torch.float32)
    w_new = torch.exp(bias_at(cv, centers, weights, sigmas, z) / kT)
    wm = weights * mask
    sw = torch.sum(wm) + torch.sum(w_new)
    sw2 = torch.sum(wm * wm) + torch.sum(w_new * w_new)
    n_eff = (sw * sw) / torch.clamp(sw2, min=_TINY)
    shrink = (n_eff * (d + 2) / 4.0) ** (-1.0 / (d + 4))
    sigma_new = torch.clamp(sigma * shrink, min=sigma_min)
    thresh2 = (merge_threshold * sigma_new) ** 2
    zero = torch.zeros((), dtype=torch.float32, device=cv.device)
    for i in range(W):
        s, w = cv[i], w_new[i]
        act = slot_idx < count
        d2 = torch.sum((centers - s[None, :]) ** 2, dim=-1)
        d2 = torch.where(act, d2, torch.full_like(d2, math.inf))
        # the first of equal minima, as jnp.argmin; every index below is a
        # one-element tensor, so that nothing is read back to the host
        j = torch.argmin(d2).reshape(1)
        merge = (torch.amin(d2) < thresh2) | (count >= K)
        slot = torch.where(merge, j, torch.clamp(count, max=K - 1))
        w_i = torch.where(merge, weights.index_select(0, slot)[0], zero)
        mu_i = torch.where(merge, centers.index_select(0, slot)[0],
                           torch.zeros_like(s))
        s_i = torch.where(merge, sigmas.index_select(0, slot)[0], zero)
        wt = w_i + w
        mu = (w_i * mu_i + w * s) / wt
        # moment-preserving isotropic merge: match the dim-averaged second
        # moment of the two-kernel mixture
        m2 = (w_i * (s_i**2 + torch.sum(mu_i**2) / d)
              + w * (sigma_new**2 + torch.sum(s**2) / d)) / wt
        sig_m = torch.sqrt(torch.clamp(m2 - torch.sum(mu**2) / d,
                                       min=sigma_min**2))
        centers.index_copy_(0, slot, mu[None])
        weights.index_copy_(0, slot, wt.reshape(1))
        sigmas.index_copy_(0, slot, sig_m.reshape(1))
        count += (~merge).to(count.dtype)
