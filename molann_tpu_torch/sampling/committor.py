"""First-passage committor estimation and a torsion-rotation helper (the
port of ``molann_tpu/sampling/committor.py``).

The committor q(x) — the probability that dynamics from x reaches
product basin B before reactant basin A — is the standard validation of
a trained CV. :func:`empirical_committor` runs many independent
overdamped replicas per start configuration as one batch, each frozen at
its first basin entry. :func:`rotate_torsion` is host numpy, carried from
the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import langevin as _lv

__all__ = ["empirical_committor", "rotate_torsion"]


def rotate_torsion(universe, quadruple, angle, *, bond_cutoff=1.8):
    """Rotate the dihedral ``quadruple`` (0-based ``(i, j, k, l)``) of a
    universe's geometry by ``angle`` radians; returns new positions
    ``[n, 3]`` (float32, numpy). All atoms on the ``k``-side of the
    ``j-k`` bond rotate about that axis."""
    from .potentials import _bond_graph

    pos = np.array(universe.atoms.positions, dtype=np.float64)
    i, j, k, l = (int(a) for a in quadruple)
    adj, _, _ = _bond_graph(pos.astype(np.float32), bond_cutoff)

    # atoms reachable from k without passing through j: the rotating side
    side, stack = {k}, [k]
    while stack:
        a = stack.pop()
        for b in adj[a]:
            if b != j and b not in side:
                side.add(b)
                stack.append(b)
    # ring detection: reaching any OTHER neighbor of j means a path
    # around the axis — the j-k bond closes a ring
    if any(b in side for b in adj[j] if b != k):
        raise ValueError("torsion axis is part of a ring; rotation is "
                         "not defined")

    axis = pos[k] - pos[j]
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    ux, uy, uz = axis
    rot = np.array([
        [c + ux * ux * (1 - c), ux * uy * (1 - c) - uz * s,
         ux * uz * (1 - c) + uy * s],
        [uy * ux * (1 - c) + uz * s, c + uy * uy * (1 - c),
         uy * uz * (1 - c) - ux * s],
        [uz * ux * (1 - c) - uy * s, uz * uy * (1 - c) + ux * s,
         c + uz * uz * (1 - c)],
    ])
    out = pos.copy()
    idx = sorted(side)
    out[idx] = (out[idx] - pos[j]) @ rot.T + pos[j]
    return out.astype(np.float32)


def empirical_committor(energy_fn, x0, in_a_fn, in_b_fn, *, n_steps, dt,
                        kT, generator, n_replicas=32):
    """Monte-Carlo first-passage committor estimates.

    For each of ``W`` start configurations, integrate ``n_replicas``
    independent overdamped-Langevin replicas until each first enters
    basin A or basin B; a replica is frozen the step it resolves.

    energy_fn: ``[M, n, 3] -> [M]``.
    x0: ``[W, n, 3]`` start configurations.
    in_a_fn / in_b_fn: ``[M, n, 3] -> [M]`` boolean basin indicators
    (checked on the START states too).
    generator: ``torch.Generator`` on the walkers' device (one normal
    draw of ``[W * n_replicas, n, 3]`` a step).

    Returns ``(q_hat [W], resolved_frac [W])``: the fraction of RESOLVED
    replicas that hit B first (NaN where none resolved), and the fraction
    that resolved at all.
    """
    x0 = _lv._tensor(x0)
    _lv._check_generator(generator, x0)
    w = x0.shape[0]
    x = torch.repeat_interleave(x0, n_replicas, dim=0)  # [W*R, n, 3]
    noise = math.sqrt(2.0 * float(kT) * float(dt))
    grad = _lv._grad_fn(lambda xx: torch.sum(energy_fn(xx)))

    def classify(xx, state):
        with torch.no_grad():
            hit_b = torch.as_tensor(in_b_fn(xx), device=xx.device).bool()
            hit_a = torch.as_tensor(in_a_fn(xx), device=xx.device).bool()
        state = torch.where((state == 0) & hit_b, torch.ones_like(state),
                            state)
        return torch.where((state == 0) & hit_a,
                           torch.full_like(state, -1), state)

    state = classify(x, torch.zeros(w * n_replicas, dtype=torch.int32,
                                    device=x.device))
    for _ in range(n_steps):
        xi = _lv._normal(x.shape, generator)
        xn = x - dt * grad(x) + noise * xi
        live = (state == 0)[:, None, None]
        x = torch.where(live, xn, x)  # resolved replicas are frozen
        state = classify(x, state)

    state = state.reshape(w, n_replicas)
    n_b = torch.sum(state == 1, dim=1).to(torch.float32)
    n_resolved = torch.sum(state != 0, dim=1).to(torch.float32)
    q = torch.where(n_resolved > 0,
                    n_b / torch.clamp(n_resolved, min=1.0),
                    torch.full_like(n_b, float("nan")))
    return q, n_resolved / n_replicas
