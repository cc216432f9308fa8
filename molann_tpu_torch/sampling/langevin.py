"""Langevin integration as a loop over preallocated device tensors (the
port of ``molann_tpu/sampling/langevin.py``).

Two integrators, both vectorized over a leading walker axis (walkers are
independent, exactly like the library's trajectory batch axis), with the
thinned trajectory written into a buffer sized up front:

- :func:`overdamped_langevin` — Brownian dynamics,
  ``x_{t+1} = x_t - dt * grad U(x_t) + sqrt(2 kT dt) * xi``.
- :func:`baoab_langevin` — underdamped (inertial) Langevin via the
  BAOAB splitting of Leimkuhler & Matthews (B: half kick, A: half
  drift, O: exact Ornstein-Uhlenbeck velocity update, A, B). Supports
  per-atom masses (see :attr:`molann_tpu_torch.topology.AtomGroup.masses`).

The JAX key becomes ``generator``, a ``torch.Generator`` on the walkers'
device. Every random number of the sampling package is drawn through
:func:`_normal` and :func:`_uniform`, so a run can be replayed with other
numbers by replacing them. No step reads a value back to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["overdamped_langevin", "baoab_langevin", "kinetic_temperature"]


def _normal(shape, generator):
    """Standard normals ``shape`` on the generator's device (float32): the
    one source of Gaussian noise of the sampling package."""
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device, dtype=torch.float32)


def _uniform(shape, generator):
    """Uniforms in [0, 1) ``shape`` on the generator's device (float32):
    the one source of uniform numbers of the sampling package."""
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device, dtype=torch.float32)


def _tensor(a, like=None, dtype=torch.float32):
    """``a`` as a ``dtype`` tensor: a tensor stays on its device; an array
    goes to the device of ``like`` if given, else to the card (the port's
    device rule: ``RuntimeError`` where there is none)."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype) if dtype is not None else a
    dev = like.device if isinstance(like, torch.Tensor) else resolve_device()
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


class _DeviceTables:
    """Named host arrays (index tables as int64, values as float32), put
    on each device once, at first use, so that a step copies nothing from
    the host."""

    def __init__(self, **arrays):
        self._host = {k: torch.as_tensor(np.asarray(v))
                      for k, v in arrays.items()}
        self._on = {}

    def on(self, device):
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = {
                k: v.to(device=device,
                        dtype=torch.float32 if v.is_floating_point()
                        else torch.long)
                for k, v in self._host.items()}
        return t


def _check_generator(generator, x):
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"generator must be a torch.Generator, got "
                        f"{type(generator).__name__}")
    if generator.device.type != x.device.type:
        raise ValueError(f"generator is on {generator.device}, walkers on "
                         f"{x.device}: make it with torch.Generator("
                         f"device=x.device)")


def _grad_fn(total):
    """``x -> d total(x) / dx`` by autograd, on a detached copy of x."""

    def grad(x, *args):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(total(xg, *args), xg)
        return g

    return grad


def overdamped_langevin(energy_fn, x0, *, n_steps, dt, kT, generator,
                        thin=10, extra_energy_fn=None):
    """Integrate ``n_steps`` of overdamped Langevin dynamics.

    energy_fn: ``[W, n, 3] -> [W]`` base potential.
    x0: ``[W, n, 3]`` walker start coordinates.
    generator: ``torch.Generator`` on the walkers' device.
    thin: record every ``thin``-th frame (``n_steps % thin == 0``).
    extra_energy_fn: optional additional ``[W, n, 3] -> [W]`` term (a
    bias); gradients of the SUM drive the dynamics.

    Returns ``(traj [n_steps//thin, W, n, 3], x_final [W, n, 3])``.
    """
    if n_steps % thin:
        raise ValueError(f"n_steps ({n_steps}) must be a multiple of "
                         f"thin ({thin})")
    x = _tensor(x0)
    _check_generator(generator, x)
    noise_scale = math.sqrt(2.0 * float(kT) * float(dt))

    def total(xx):
        e = torch.sum(energy_fn(xx))
        if extra_energy_fn is not None:
            e = e + torch.sum(extra_energy_fn(xx))
        return e

    grad = _grad_fn(total)
    traj = x.new_empty((n_steps // thin,) + tuple(x.shape))
    for p in range(n_steps // thin):
        for _ in range(thin):
            xi = _normal(x.shape, generator)
            x = x - dt * grad(x) + noise_scale * xi
        traj[p] = x
    return traj, x


def _as_mass_array(mass, x0):
    """Broadcast a scalar or per-atom ``[n]`` mass to ``[n, 1]`` float32 on
    x0's device, validating positivity (a 0.0 from the topology's mass
    guesser means 'unknown element' and would divide by zero here)."""
    m = mass.detach().cpu().numpy() if isinstance(mass, torch.Tensor) \
        else np.asarray(mass)
    if np.any(m <= 0.0):
        raise ValueError(
            "all masses must be positive (0.0 means the topology "
            "could not guess the element — pass masses explicitly)"
        )
    m = m.astype(np.float32)
    if m.ndim == 0:
        m = np.full((x0.shape[-2],), m, np.float32)
    if m.ndim != 1 or m.shape[0] != x0.shape[-2]:
        raise ValueError(
            f"mass must be a scalar or [n_atoms]={x0.shape[-2]} vector, "
            f"got shape {tuple(m.shape)}"
        )
    return torch.as_tensor(m, device=x0.device)[:, None]


def baoab_langevin(energy_fn, x0, *, n_steps, dt, kT, gamma, generator,
                   mass=1.0, v0=None, thin=10, extra_energy_fn=None):
    """Integrate ``n_steps`` of underdamped Langevin dynamics (BAOAB).

    One step is the Leimkuhler-Matthews splitting
    ``B(dt/2) A(dt/2) O(dt) A(dt/2) B(dt/2)`` where B kicks velocities by
    ``-grad U / m``, A drifts positions, and O is the EXACT
    Ornstein-Uhlenbeck update ``v <- c1 v + sqrt((1-c1^2) kT/m) xi`` with
    ``c1 = exp(-gamma dt)``. Force is evaluated once per step (the
    trailing B's force is reused as the next step's leading B).

    energy_fn: ``[W, n, 3] -> [W]`` base potential.
    x0: ``[W, n, 3]`` walker start coordinates.
    gamma: friction (1/time units of ``dt``).
    generator: ``torch.Generator`` on the walkers' device.
    mass: scalar or per-atom ``[n]`` masses; velocities have units of
        position/time, ``kT`` of energy.
    v0: ``[W, n, 3]`` start velocities; default: Maxwell-Boltzmann draw
        at ``kT`` (drawn before the steps' noise).
    thin: record every ``thin``-th frame (``n_steps % thin == 0``).
    extra_energy_fn: optional additional ``[W, n, 3] -> [W]`` term (a
        bias); gradients of the SUM drive the dynamics.

    Returns ``(traj [n_steps//thin, W, n, 3], x_final, v_final)``.
    """
    if n_steps % thin:
        raise ValueError(f"n_steps ({n_steps}) must be a multiple of "
                         f"thin ({thin})")
    x = _tensor(x0)
    _check_generator(generator, x)
    m = _as_mass_array(mass, x)
    c1 = math.exp(-float(gamma) * float(dt))
    sigma = torch.sqrt((1.0 - c1 * c1) * float(kT) / m)  # [n, 1]
    half = 0.5 * float(dt)

    def total(xx):
        e = torch.sum(energy_fn(xx))
        if extra_energy_fn is not None:
            e = e + torch.sum(extra_energy_fn(xx))
        return e

    grad = _grad_fn(total)
    if v0 is None:
        v = torch.sqrt(float(kT) / m) * _normal(x.shape, generator)
    else:
        v = _tensor(v0, like=x)
    f = -grad(x)
    traj = x.new_empty((n_steps // thin,) + tuple(x.shape))
    for p in range(n_steps // thin):
        for _ in range(thin):
            v = v + half * f / m               # B
            x = x + half * v                   # A
            xi = _normal(v.shape, generator)
            v = c1 * v + sigma * xi            # O (exact OU)
            x = x + half * v                   # A
            f = -grad(x)
            v = v + half * f / m               # B
        traj[p] = x
    return traj, x, v


def kinetic_temperature(v, mass=1.0):
    """Instantaneous kinetic temperature ``kT_kin = sum(m v^2) / n_dof``
    per walker: ``v [W, n, 3] -> [W]`` (same energy units as ``kT``)."""
    v = _tensor(v)
    m = _as_mass_array(mass, v)
    return torch.sum(m * v * v, dim=(-1, -2)) / (v.shape[-1] * v.shape[-2])
