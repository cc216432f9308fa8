"""Markov state models over discretized CV trajectories (host numpy,
carried from ``molann_tpu/sampling/msm.py``).

The standard downstream analysis of a learned collective variable
(reference README.rst:51 — the CVs exist to coarse-grain dynamics):
discretize the CV time series into states, count lag-time transitions,
estimate a (reversible) transition matrix, and read off stationary
populations, relaxation timescales, and the Chapman-Kolmogorov test
that validates Markovianity at the chosen lag.

Estimators follow the standard MSM literature (Prinz et al., JCP 134,
174105 (2011)): sliding-window counts, maximum-likelihood reversible
transition matrix via the self-consistent x_ij iteration, implied
timescales ``-lag / log |lambda_i|``.

Host-side numpy throughout — count matrices are tiny; the heavy work
(producing the CV series) already ran on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "grid_assign",
    "count_matrix",
    "transition_matrix",
    "MSM",
    "estimate_msm",
    "ck_test",
    "mfpt",
    "pcca_memberships",
    "coarse_grain",
    "bootstrap_msm",
    "BootstrapMSM",
]


def grid_assign(values, edges):
    """Assign CV samples to grid states.

    values: ``[T]`` or ``[T, d]`` CV samples. edges: one 1-D array of bin
    edges per CV dimension. Returns integer labels ``[T]`` in
    ``[0, prod(n_bins))`` (row-major over dimensions); samples outside
    the grid clamp to the boundary bins.
    """
    v = np.asarray(values, np.float64)
    if v.ndim == 1:
        v = v[:, None]
    edges = [np.asarray(e, np.float64) for e in (
        [edges] if np.ndim(edges[0]) == 0 else edges)]
    if len(edges) != v.shape[1]:
        raise ValueError(
            f"got {len(edges)} edge arrays for {v.shape[1]}-dim CVs"
        )
    labels = np.zeros(v.shape[0], np.int64)
    for k, e in enumerate(edges):
        nb = len(e) - 1
        if nb < 1:
            raise ValueError("each edges array needs >= 2 entries")
        idx = np.clip(np.searchsorted(e, v[:, k], side="right") - 1, 0,
                      nb - 1)
        labels = labels * nb + idx
    return labels


def count_matrix(labels, n_states, lag, *, sliding=True):
    """Transition count matrix ``C[i, j]`` = #(s_t = i, s_{t+lag} = j).

    labels: one ``[T]`` integer series or a list of them (independent
    trajectories/walkers — pairs never cross series). ``sliding`` counts
    every t (standard); ``False`` strides by ``lag`` (independent
    counts, for error estimation).
    """
    if lag < 1:
        raise ValueError(f"lag must be >= 1, got {lag}")
    series = labels if isinstance(labels, (list, tuple)) else [labels]
    c = np.zeros((n_states, n_states), np.float64)
    for s in series:
        s = np.asarray(s, np.int64)
        if s.min() < 0 or s.max() >= n_states:
            raise ValueError("labels outside [0, n_states)")
        if len(s) <= lag:
            continue
        a = s[:-lag] if sliding else s[: (len(s) - 1) // lag * lag : lag]
        b = s[lag:] if sliding else s[lag : (len(s) - 1) // lag * lag
                                      + lag : lag]
        np.add.at(c, (a, b), 1.0)
    return c


def transition_matrix(counts, *, reversible=True, tol=1e-10,
                      max_iter=10_000):
    """Maximum-likelihood transition matrix from a count matrix.

    reversible=True runs the standard self-consistent iteration for the
    detailed-balance-constrained MLE (Prinz et al. 2011, eq. 27):
    ``x_ij <- (c_ij + c_ji) / (c_i/x_i + c_j/x_j)``, ``T = x / rowsum``;
    the stationary distribution is then ``x_i / sum(x)`` exactly.
    reversible=False is the row-normalized MLE. States with zero
    outgoing counts get a self-loop (absorbing placeholder).

    Returns ``(T [n, n], pi [n])``.
    """
    c = np.asarray(counts, np.float64)
    n = c.shape[0]
    if c.shape != (n, n) or (c < 0).any():
        raise ValueError("counts must be a nonnegative square matrix")
    rows = c.sum(axis=1)
    if not reversible:
        t = np.where(rows[:, None] > 0, c / np.maximum(rows, 1)[:, None],
                     np.eye(n))
        # stationary: left eigenvector of the largest eigenvalue
        w, v = np.linalg.eig(t.T)
        i = int(np.argmax(w.real))
        pi = np.abs(v[:, i].real)
        return t, pi / pi.sum()

    csym = c + c.T
    x = csym.copy()  # init: symmetrized counts
    ci = rows
    active = csym.sum(axis=1) > 0
    for _ in range(max_iter):
        xi = x.sum(axis=1)
        denom = (np.divide(ci, xi, out=np.zeros(n), where=xi > 0)[:, None]
                 + np.divide(ci, xi, out=np.zeros(n), where=xi > 0)[None, :])
        x_new = np.divide(csym, denom, out=np.zeros_like(x),
                          where=denom > 0)
        delta = np.abs(x_new - x).max()
        x = x_new
        if delta < tol * max(1.0, x.max()):
            break
    xi = x.sum(axis=1)
    t = np.where(active[:, None], np.divide(
        x, np.maximum(xi, 1e-300)[:, None]), np.eye(n))
    pi = np.where(active, xi, 0.0)
    s = pi.sum()
    return t, (pi / s if s > 0 else np.full(n, 1.0 / n))


@dataclass
class MSM:
    """Estimated Markov state model at one lag.

    transition ``[n, n]``, stationary ``pi [n]``, ``lag`` (frames), and
    eigenvalues (descending by magnitude, excluding the stationary 1).
    """

    transition: np.ndarray
    pi: np.ndarray
    lag: float
    eigenvalues: np.ndarray

    def timescales(self):
        """Implied timescales ``-lag / log |lambda_i|`` of the non-
        stationary eigenvalues (same frame units as ``lag``)."""
        lam = np.abs(self.eigenvalues)
        out = np.full(lam.shape, np.inf)
        ok = (lam > 0) & (lam < 1)
        out[ok] = -self.lag / np.log(lam[ok])
        return out

    def mfpt(self, targets):
        """Mean first-passage times to a target state set (frames) —
        see :func:`mfpt`."""
        return mfpt(self.transition, targets, lag=self.lag)

    def metastable_sets(self, n_sets):
        """PCCA+ coarse-graining into ``n_sets`` metastable sets:
        returns ``(assignments [n], memberships [n, n_sets])`` — see
        :func:`pcca_memberships`."""
        chi = pcca_memberships(self.transition, n_sets)
        return chi.argmax(axis=1), chi

    def coarse_grain(self, n_sets):
        """``(T_coarse [m, m], pi_coarse [m], memberships [n, m])`` —
        see :func:`coarse_grain`."""
        chi = pcca_memberships(self.transition, n_sets)
        tc, pic = coarse_grain(self.transition, self.pi, chi)
        return tc, pic, chi

    def tpt(self, source, target):
        """Transition-path-theory analysis of the ``source -> target``
        reaction (committors, reactive flux, rate per frame, dominant
        pathways) — see :func:`.tpt.tpt`."""
        from .tpt import tpt as _tpt

        return _tpt(self.transition, self.pi, source, target,
                    lag=self.lag)


def estimate_msm(labels, n_states, lag, *, reversible=True, sliding=True):
    """Count + estimate in one call -> :class:`MSM`."""
    c = count_matrix(labels, n_states, lag, sliding=sliding)
    t, pi = transition_matrix(c, reversible=reversible)
    w = np.linalg.eigvals(t)
    w = w[np.argsort(-np.abs(w))]
    # drop the stationary eigenvalue (the one closest to 1)
    return MSM(transition=t, pi=pi, lag=float(lag),
               eigenvalues=w[1:].real if reversible else w[1:])


def mfpt(transition, targets, *, lag=1.0):
    """Mean first-passage time from every state to a target set.

    Solves the standard linear system ``m_i = lag + sum_j T_ij m_j``
    over non-target states (``m = 0`` on targets). States that cannot
    reach the target set at all (e.g. the self-loop placeholders grid
    MSMs carry for never-visited bins) get ``inf`` instead of poisoning
    the solve. Returns ``m [n]`` in the same units as ``lag``.
    """
    t = np.asarray(transition, np.float64)
    n = t.shape[0]
    idx = np.asarray(targets, np.int64).reshape(-1)
    if idx.size == 0:
        raise ValueError("targets must name at least one state")
    if ((idx < 0) | (idx >= n)).any():
        raise ValueError(
            f"target states must be in [0, {n - 1}], got "
            f"{sorted(int(i) for i in idx[(idx < 0) | (idx >= n)])}"
        )
    tgt = np.zeros(n, bool)
    tgt[idx] = True
    if tgt.all():
        return np.zeros(n)
    # reverse reachability: which states have ANY path into the targets
    adj = t > 0
    reach = tgt.copy()
    frontier = tgt
    while frontier.any():
        frontier = adj[:, frontier].any(axis=1) & ~reach
        reach |= frontier
    m = np.full(n, np.inf)
    m[tgt] = 0.0
    solve = reach & ~tgt
    if solve.any():
        a = np.eye(int(solve.sum())) - t[np.ix_(solve, solve)]
        m[solve] = np.linalg.solve(a, np.full(int(solve.sum()), lag))
    return m


def pcca_memberships(transition, n_sets):
    """PCCA+ fuzzy memberships ``chi [n, n_sets]`` of each microstate
    in ``n_sets`` metastable sets (Deuflhard & Weber, "Robust Perron
    cluster analysis in conformation dynamics", 2005).

    The dominant ``n_sets`` right eigenvectors of a metastable
    transition matrix span a simplex whose vertices are the pure sets;
    the standard inner-simplex construction picks the vertex rows
    greedily (farthest-point in eigenvector space) and maps every row
    through the vertex basis, followed by the usual clip-and-renormalize
    feasibility projection. Rows of ``chi`` sum to 1; crisp assignments
    are ``chi.argmax(axis=1)``. Meaningful for reversible (real-
    spectrum) models — complex parts are discarded with a warning-free
    ``.real`` after sorting by real part.
    """
    t = np.asarray(transition, np.float64)
    n = t.shape[0]
    m = int(n_sets)
    if not 2 <= m <= n:
        raise ValueError(f"n_sets must be in [2, {n}], got {n_sets}")
    w, v = np.linalg.eig(t)
    order = np.argsort(-w.real)
    x = v[:, order[:m]].real  # [n, m], first column ~ constant
    x = x / np.linalg.norm(x, axis=0, keepdims=True)
    # inner-simplex vertex search: start from the row farthest from the
    # origin, then repeatedly take the row farthest from the affine span
    # of the chosen vertices (classic PCCA+ initialization)
    verts = [int(np.argmax(np.linalg.norm(x, axis=1)))]
    proj = x - x[verts[0]]  # differences from the first vertex
    for _ in range(1, m):
        verts.append(int(np.argmax(np.linalg.norm(proj, axis=1))))
        v_new = proj[verts[-1]]
        nv = np.linalg.norm(v_new)
        if nv > 0:  # deflate the chosen direction (Gram-Schmidt)
            v_new = v_new / nv
            proj = proj - np.outer(proj @ v_new, v_new)
    a = x[verts]  # [m, m] vertex basis
    chi = x @ np.linalg.inv(a)
    # feasibility projection: memberships live on the simplex
    chi = np.clip(chi, 0.0, None)
    s = chi.sum(axis=1, keepdims=True)
    return chi / np.maximum(s, 1e-300)


def coarse_grain(transition, pi, memberships):
    """Membership-weighted coarse-graining of ``(T, pi)`` onto the
    metastable sets: ``T_c = (chi^T D chi)^{-1} chi^T D T chi`` with
    ``D = diag(pi)`` (the standard PCCA+ projection — row-stochastic
    when ``chi`` partitions unity), ``pi_c = chi^T pi``. Returns
    ``(T_c [m, m], pi_c [m])``.
    """
    t = np.asarray(transition, np.float64)
    pi = np.asarray(pi, np.float64)
    chi = np.asarray(memberships, np.float64)
    d = chi.T * pi[None, :]  # chi^T D
    tc = np.linalg.solve(d @ chi, d @ t @ chi)
    pic = chi.T @ pi
    return tc, pic


@dataclass
class BootstrapMSM:
    """Bootstrap uncertainty of an MSM estimate.

    timescales ``[n_samples, k]`` and pi ``[n_samples, n]`` across the
    bootstrap resamples (non-converging timescales come back ``inf`` —
    use the percentile CIs, not moments). ``n_resampled``: how many
    units (trajectories, or circular blocks of ``block`` frames for a
    single trajectory) each resample draws.
    """

    timescales: np.ndarray
    pi: np.ndarray
    block: int
    n_resampled: int

    def timescale_ci(self, alpha=0.95):
        """Percentile confidence intervals ``(lo [k], hi [k])`` for the
        implied timescales."""
        q = (1.0 - alpha) / 2.0
        return (np.quantile(self.timescales, q, axis=0),
                np.quantile(self.timescales, 1.0 - q, axis=0))

    def pi_ci(self, alpha=0.95):
        """Percentile confidence intervals ``(lo [n], hi [n])`` for the
        stationary populations."""
        q = (1.0 - alpha) / 2.0
        return (np.quantile(self.pi, q, axis=0),
                np.quantile(self.pi, 1.0 - q, axis=0))


def bootstrap_msm(labels, n_states, lag, *, n_samples=100, seed=0,
                  reversible=True, sliding=True, n_timescales=3,
                  block=None):
    """Bootstrap error bars for MSM timescales and populations.

    Multiple trajectories (a list of label series) are resampled with
    replacement at the trajectory level — the standard independent-unit
    bootstrap. A single trajectory is cut into circular blocks of
    ``block`` frames (default ``max(10*lag, T//20)`` — long enough to
    preserve the lag correlation structure) and the blocks are
    resampled. Each resample is re-estimated with the same settings as
    :func:`estimate_msm`; timescales past the resample's spectrum come
    back ``inf`` and states never visited in a resample get stationary
    weight 0, so the percentile CIs (:class:`BootstrapMSM`) remain
    meaningful even when resamples disagree about connectivity.
    """
    if n_samples < 2:
        raise ValueError(f"n_samples must be >= 2, got {n_samples}")
    rng = np.random.default_rng(seed)
    if isinstance(labels, (list, tuple)):
        units = [np.asarray(s, np.int64) for s in labels]
        block_len = 0
    else:
        s = np.asarray(labels, np.int64)
        t = len(s)
        block_len = int(block) if block else max(10 * int(lag), t // 20)
        block_len = max(block_len, lag + 1)
        if t <= block_len:
            raise ValueError(
                f"trajectory ({t} frames) shorter than the bootstrap "
                f"block ({block_len}); pass more data or block="
            )
        # circular blocks: every start position is a valid unit
        starts = rng.integers(0, t, size=(n_samples, t // block_len))
        idx = (starts[..., None] + np.arange(block_len)) % t
        units = None
    ts_out = np.full((n_samples, int(n_timescales)), np.inf)
    pi_out = np.zeros((n_samples, int(n_states)))
    n_resampled = (len(units) if units is not None
                   else (len(labels) // block_len))
    for b in range(n_samples):
        if units is not None:
            pick = rng.integers(0, len(units), size=len(units))
            series = [units[i] for i in pick]
        else:
            series = [s[row] for row in idx[b]]
        m = estimate_msm(series, n_states, lag, reversible=reversible,
                         sliding=sliding)
        ts = m.timescales()[: int(n_timescales)]
        ts_out[b, : len(ts)] = ts
        pi_out[b] = m.pi
    return BootstrapMSM(timescales=ts_out, pi=pi_out,
                        block=int(block_len), n_resampled=int(n_resampled))


def ck_test(labels, n_states, lag, *, factors=(2, 4), reversible=True):
    """Chapman-Kolmogorov test: is ``T(lag)^k ~ T(k*lag)``?

    For each factor ``k``, estimates an MSM at ``k*lag`` and compares it
    with the ``lag``-model propagated ``k`` steps. Returns
    ``{k: max_ij |T(lag)^k - T(k*lag)|}`` — small values (<~0.1) mean
    the discretization is Markovian at this lag; large values mean the
    states hide slow structure (pick a longer lag or better CVs).
    """
    base = estimate_msm(labels, n_states, lag, reversible=reversible)
    out = {}
    for k in factors:
        ref = estimate_msm(labels, n_states, int(k) * lag,
                           reversible=reversible)
        prop = np.linalg.matrix_power(base.transition, int(k))
        out[int(k)] = float(np.abs(prop - ref.transition).max())
    return out
