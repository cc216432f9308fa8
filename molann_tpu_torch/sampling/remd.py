"""Replica-exchange (parallel-tempering) overdamped Langevin dynamics (the
port of ``molann_tpu/sampling/remd.py``).

A ladder of replicas at increasing temperatures runs as one batch
(replicas are the walker axis), with Metropolis swaps of configurations
between adjacent rungs every ``exchange_stride`` steps — alternating
even/odd pairs. Acceptance ``min(1, exp((β_i − β_j)(E_i − E_j)))``; the
acceptance counts stay tensors on the device.
"""

from __future__ import annotations

import torch

from . import langevin as _lv

__all__ = ["replica_exchange_langevin"]


def replica_exchange_langevin(energy_fn, x0, temperatures, *, n_steps,
                              dt, generator, exchange_stride=10, thin=1):
    """Integrate parallel tempering; returns per-RUNG trajectories.

    energy_fn: ``[R, n, 3] -> [R]``.
    x0: ``[R, n, 3]`` start configuration per rung (rung ``r`` runs at
    ``temperatures[r]``; sort ascending — rung 0 is the cold ensemble).
    n_steps: total dynamics steps; must divide by ``exchange_stride``.
    generator: ``torch.Generator`` on the replicas' device; each round
    draws the steps' normals, then one uniform a rung for the swaps.
    exchange_stride: steps between swap attempts. Swap rounds alternate
    between even pairs (0-1, 2-3, …) and odd pairs (1-2, 3-4, …).
    thin: record every ``thin``-th exchange round.

    Returns ``(traj [n_rounds//thin, R, n, 3], x_final [R, n, 3],
    swap_acceptance [R-1])``.
    """
    if n_steps % exchange_stride:
        raise ValueError(f"n_steps ({n_steps}) must be a multiple of "
                         f"exchange_stride ({exchange_stride})")
    n_rounds = n_steps // exchange_stride
    if n_rounds % thin:
        raise ValueError(f"exchange rounds ({n_rounds}) must divide by "
                         f"thin ({thin})")
    x = _lv._tensor(x0)
    _lv._check_generator(generator, x)
    dev = x.device
    r = x.shape[0]
    kts = _lv._tensor(temperatures, like=x)
    if tuple(kts.shape) != (r,):
        raise ValueError(f"need one temperature per replica; got "
                         f"{tuple(kts.shape)} for {r} replicas")
    betas = 1.0 / kts
    noise = torch.sqrt(2.0 * kts * float(dt))[:, None, None]
    grad = _lv._grad_fn(lambda xx: torch.sum(energy_fn(xx)))

    # swap partner tables for the two parities: partner[i] = j means rung
    # i attempts to swap with rung j this round (self-partner = no swap)
    idx = torch.arange(r, device=dev)

    def partners(parity):
        cand = torch.where((idx - parity) % 2 == 0, idx + 1, idx - 1)
        return torch.where((cand < 0) | (cand >= r), idx, cand)

    part_table = [partners(0), partners(1)]
    lo_table = [torch.minimum(idx, p) for p in part_table]
    slot_table = [torch.clamp(lo, 0, max(r - 2, 0)) for lo in lo_table]
    acc = torch.zeros(max(r - 1, 0), dtype=torch.int64, device=dev)
    att = torch.zeros_like(acc)
    traj = x.new_empty((n_rounds // thin,) + tuple(x.shape))
    for rnd in range(n_rounds):
        for _ in range(exchange_stride):
            xi = _lv._normal(x.shape, generator)
            x = x - dt * grad(x) + noise * xi
        parity = rnd % 2
        part, lo = part_table[parity], lo_table[parity]
        with torch.no_grad():
            e = energy_fn(x)  # [R]
            # Metropolis on each pair, the same Δ from both sides; one
            # uniform per PAIR (the lower index's) keeps the decision
            # consistent
            delta = (betas - betas[part]) * (e - e[part])
            uni = _lv._uniform((r,), generator)[lo]
            accept = (part != idx) & (uni < torch.exp(
                torch.clamp(delta, max=0.0)))
            x = torch.where(accept[:, None, None], x[part], x)
            # count each accepted pair once, at its lower rung
            if r > 1:
                acc.index_add_(0, slot_table[parity],
                               (accept & (idx < part)).to(acc.dtype))
                att.index_add_(0, slot_table[parity],
                               ((part != idx) & (idx < part)).to(att.dtype))
        if (rnd + 1) % thin == 0:
            traj[rnd // thin] = x
    rate = acc.to(torch.float32) / torch.clamp(att, min=1).to(torch.float32)
    return traj, x, rate
