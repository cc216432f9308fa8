"""Transition path theory over Markov state models (host numpy, carried
from ``molann_tpu/sampling/tpt.py``).

Given an MSM (:mod:`.msm`) and two state sets A (reactant) and B
(product), TPT (Metzner, Schuette, Vanden-Eijnden, Multiscale Model.
Simul. 7, 1192 (2009)) decomposes the stationary dynamics into reactive
A->B events: committor probabilities, the reactive flux network, the
A->B rate, and the dominant transition pathways with their bottlenecks.
This is the quantitative endpoint of the reference's research workflow —
a trained CV (reference README.rst:51) discretizes into an MSM, and TPT
turns that into mechanisms and rates.

Host-side numpy like :mod:`.msm` — the matrices are tiny; the card
already did the heavy lifting producing the CV series.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["forward_committor", "tpt", "TPT"]


def _state_mask(n, states, label):
    m = np.zeros(n, bool)
    idx = np.asarray(states, np.int64).reshape(-1)
    if idx.size == 0:
        raise ValueError(f"{label} must name at least one state")
    if (idx < 0).any() or (idx >= n).any():
        raise ValueError(f"{label} states outside [0, {n})")
    m[idx] = True
    return m


def _reach(adj, targets):
    """States with ANY directed path into the target set (incl. it)."""
    reach = targets.copy()
    frontier = targets
    while frontier.any():
        frontier = adj[:, frontier].any(axis=1) & ~reach
        reach |= frontier
    return reach


def forward_committor(transition, source, target):
    """Probability of hitting ``target`` before ``source`` from each
    state: ``q = 0`` on source, ``1`` on target, and
    ``q_i = sum_j T_ij q_j`` in between (the discrete committor
    equation). Intermediate states with no path to either set get 0
    (they never commit — e.g. the self-loop placeholders grid MSMs
    carry for never-visited bins). Returns ``q [n]``.
    """
    t = np.asarray(transition, np.float64)
    n = t.shape[0]
    a = _state_mask(n, source, "source")
    b = _state_mask(n, target, "target")
    if (a & b).any():
        raise ValueError("source and target sets overlap")
    q = np.zeros(n)
    q[b] = 1.0
    mid = ~(a | b)
    if not mid.any():
        return q
    # dynamics absorbed at A u B: solve only intermediates that can
    # actually reach the boundary (others sit in a trapped component)
    adj_mid = (t > 0) & mid[:, None]  # walk stops once it leaves 'mid'
    solve = mid & _reach(adj_mid | np.diag(a | b), a | b)
    solve &= ~(a | b)
    if solve.any():
        k = int(solve.sum())
        lhs = np.eye(k) - t[np.ix_(solve, solve)]
        rhs = t[np.ix_(solve, np.flatnonzero(b))].sum(axis=1)
        q[solve] = np.linalg.solve(lhs, rhs)
    return np.clip(q, 0.0, 1.0)


@dataclass
class TPT:
    """Transition-path-theory analysis of one A->B reaction.

    q_plus/q_minus ``[n]`` forward/backward committors; flux ``[n, n]``
    reactive probability current ``pi_i q-_i T_ij q+_j``; net_flux its
    antisymmetrized positive part; total_flux the A->B probability
    current per lag; rate the A->B transition rate per frame
    (``total_flux / (lag * sum_i pi_i q-_i)``); lag in frames.
    """

    q_plus: np.ndarray
    q_minus: np.ndarray
    flux: np.ndarray
    net_flux: np.ndarray
    total_flux: float
    rate: float
    lag: float
    source: np.ndarray
    target: np.ndarray

    def pathways(self, n_paths=5):
        """Dominant reactive pathways by iterative bottleneck
        decomposition: repeatedly extract the widest (max-min-capacity)
        A->B path from the net-flux network and subtract its bottleneck
        capacity from every edge on it. Returns a list of
        ``(path [list of states], path_flux)`` sorted as extracted
        (successively smaller); stops early when the network is dry.
        """
        f = self.net_flux.copy()
        n = f.shape[0]
        src = set(self.source.tolist())
        tgt = set(self.target.tolist())
        out = []
        for _ in range(int(n_paths)):
            # widest-path Dijkstra from the source set
            width = np.full(n, -np.inf)
            prev = np.full(n, -1, np.int64)
            width[list(src)] = np.inf
            done = np.zeros(n, bool)
            while True:
                cand = np.where(done, -np.inf, width)
                u = int(cand.argmax())
                if cand[u] <= 0:
                    break
                done[u] = True
                if u in tgt:
                    continue  # paths end at the target set
                w_new = np.minimum(width[u], f[u])
                upd = (w_new > width) & ~done
                width[upd] = w_new[upd]
                prev[upd] = u
            reached = [s for s in tgt if width[s] > 0 and done[s]]
            if not reached:
                break
            end = max(reached, key=lambda s: width[s])
            cap = float(width[end])
            path = [end]
            while path[-1] not in src:
                path.append(int(prev[path[-1]]))
            path.reverse()
            for a_, b_ in zip(path[:-1], path[1:]):
                f[a_, b_] -= cap
            out.append((path, cap))
        return out


def tpt(transition, pi, source, target, *, lag=1.0):
    """Full TPT analysis -> :class:`TPT`.

    transition ``[n, n]`` row-stochastic, pi ``[n]`` its stationary
    distribution (both straight from :func:`.msm.estimate_msm`), source/
    target the A/B state sets, lag the MSM lag in frames (sets the units
    of ``rate``).
    """
    t = np.asarray(transition, np.float64)
    pi = np.asarray(pi, np.float64)
    n = t.shape[0]
    a = np.asarray(source, np.int64).reshape(-1)
    b = np.asarray(target, np.int64).reshape(-1)
    qp = forward_committor(t, a, b)
    # backward committor: committor of the time-reversed chain B <- A
    with np.errstate(divide="ignore", invalid="ignore"):
        trev = np.where(pi[:, None] > 0, (pi[None, :] * t.T) / pi[:, None],
                        0.0)
    # unpopulated states: keep a self-loop so rows stay stochastic
    rows = trev.sum(axis=1)
    trev[rows == 0] = np.eye(n)[rows == 0]
    qm = forward_committor(trev, b, a)
    flux = pi[:, None] * qm[:, None] * t * qp[None, :]
    np.fill_diagonal(flux, 0.0)
    net = np.maximum(flux - flux.T, 0.0)
    amask = _state_mask(n, a, "source")
    total = float(flux[amask, :].sum() - flux[:, amask].sum())
    denom = float((pi * qm).sum()) * float(lag)
    rate = total / denom if denom > 0 else 0.0
    return TPT(q_plus=qp, q_minus=qm, flux=flux, net_flux=net,
               total_flux=total, rate=rate, lag=float(lag),
               source=np.unique(a), target=np.unique(b))
