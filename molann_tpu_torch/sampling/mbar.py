"""MBAR reweighting and umbrella sampling along model CVs (the port of
``molann_tpu/sampling/mbar.py``).

- :func:`umbrella_sampling`: all windows integrate in one batched run
  (windows are the walker axis of
  :func:`~molann_tpu_torch.sampling.overdamped_langevin`), biased by
  harmonic restraints on any differentiable CV function;
- :func:`mbar`: the self-consistent MBAR fixed point (Shirts & Chodera
  2008) in float32 log space, returning window free energies and
  unbiased per-sample log-weights; its stop test is the one read back to
  the host each iteration, as the JAX ``while_loop``'s condition;
- :func:`pmf_from_samples`: weighted-histogram free-energy profile from
  those weights (host numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from .langevin import _tensor, overdamped_langevin

__all__ = ["mbar", "umbrella_sampling", "pmf_from_samples"]


def mbar(u_kn, n_k, *, target_u_n=None, tol=1e-10, max_iter=10_000):
    """Solve the MBAR equations for ``K`` ensembles over pooled samples.

    u_kn: ``[K, N]`` REDUCED (dimensionless) bias potential of ensemble
    ``k`` evaluated at pooled sample ``n``. Row ``k`` of ``u_kn`` must
    correspond to entry ``k`` of ``n_k`` (samples contributed per
    ensemble, ``sum(n_k) == N``).

    target_u_n: optional ``[N]`` reduced potential of the TARGET
    ensemble the returned weights should represent (default zeros, the
    shared base for umbrella windows).

    Returns ``(f_k [K], log_w_n [N])``: dimensionless window free
    energies (gauge ``f_0 = 0``) and normalized target-ensemble
    log-weights (``logsumexp(log_w_n) == 0``), on the device of ``u_kn``.

    The self-consistent iteration
    ``f_k = -log Σ_n exp(-u_kn) / Σ_j N_j exp(f_j - u_jn)`` runs in
    float32 log space until max |Δf| <= tol or ``max_iter`` iterations,
    the JAX loop's stop rule.
    """
    u_kn = _tensor(u_kn)
    n_k = _tensor(n_k, like=u_kn)
    log_nk = torch.log(n_k)

    def log_denominator(f):
        # [N]: log Σ_k N_k exp(f_k - u_kn)
        return torch.logsumexp(log_nk[:, None] + f[:, None] - u_kn, dim=0)

    def update(f):
        logden = log_denominator(f)
        newf = -torch.logsumexp(-u_kn - logden[None, :], dim=1)
        return newf - newf[0]

    f = torch.zeros(u_kn.shape[0], dtype=torch.float32, device=u_kn.device)
    delta = torch.tensor(float("inf"), dtype=torch.float32)
    it = 0
    while bool(delta > tol) and it < max_iter:
        newf = update(f)
        delta = torch.max(torch.abs(newf - f))
        f = newf
        it += 1

    log_w = -log_denominator(f)
    if target_u_n is not None:
        log_w = log_w - _tensor(target_u_n, like=u_kn)
    log_w = log_w - torch.logsumexp(log_w, dim=0)
    return f, log_w


def umbrella_sampling(energy_fn, cv_fn, x0, centers, *, k_spring, n_steps,
                      dt, kT, generator, thin=10, n_equil=0):
    """Run one harmonic umbrella window per walker, all in one batched
    run.

    energy_fn: ``[W, n, 3] -> [W]`` base potential.
    cv_fn: ``[W, n, 3] -> [W]`` differentiable collective variable (e.g.
    ``lambda x: model(x)[:, 0]``).
    x0: ``[W, n, 3]`` start configuration per window.
    centers: ``[W]`` restraint centers; restraint =
    ``k_spring/2 (cv - center)²``. generator: ``torch.Generator`` on the
    walkers' device.

    Returns ``(cv_samples [W, T], traj [T, W, n, 3])`` with the first
    ``n_equil`` recorded frames discarded.
    """
    x0 = _tensor(x0)
    centers = _tensor(centers, like=x0)

    def restraint(x):
        return 0.5 * float(k_spring) * (cv_fn(x) - centers) ** 2

    traj, _ = overdamped_langevin(
        energy_fn, x0, n_steps=n_steps, dt=dt, kT=kT, generator=generator,
        thin=thin, extra_energy_fn=restraint,
    )
    traj = traj[n_equil:]
    with torch.no_grad():
        cv = torch.stack([cv_fn(frame) for frame in traj]) if len(traj) \
            else traj.new_zeros((0, x0.shape[0]))  # [T, W]
    return cv.T, traj


def pmf_from_samples(values, log_w, grid_edges, *, kT=1.0):
    """Weighted-histogram free-energy profile.

    values ``[N]``: the observable (e.g. pooled CV samples); log_w
    ``[N]``: normalized unbiased log-weights from :func:`mbar`;
    grid_edges ``[M+1]``: histogram bin edges. Returns ``F [M]`` (numpy)
    in energy units (``kT`` sets the scale), shifted so ``min F = 0``;
    empty bins are ``inf``.
    """
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    values = host(values).reshape(-1)
    w = np.exp(host(log_w).reshape(-1))
    hist, _ = np.histogram(values, bins=host(grid_edges), weights=w)
    if not hist.any():
        edges = host(grid_edges)
        span = (f"sample range [{values.min()}, {values.max()}]"
                if values.size else "no samples at all")
        raise ValueError(
            f"no samples fall inside the grid [{edges[0]}, {edges[-1]}] "
            f"({span}); widen grid_edges to cover the data"
        )
    with np.errstate(divide="ignore"):
        f = -float(kT) * np.log(hist)
    return f - f[np.isfinite(f)].min()
