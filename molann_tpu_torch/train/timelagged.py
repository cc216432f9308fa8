"""Time-lagged CV learning: TICA and the VAMP-2 neural objective.

The port of ``molann_tpu/train/timelagged.py``. Where the eigenfunction
loss learns slow modes from forces, these learn them from dynamics: pairs
``(x_t, x_{t+tau})`` from a trajectory.

- :func:`tica`: linear time-lagged independent component analysis, the
  generalised eigenproblem ``C_0t v = lambda C_00 v``. The moments are
  float32 sums on the inputs' device, as the JAX package's jitted ones;
  the solve is numpy float64 on the host.
- :func:`vamp2_loss`: the negated VAMP-2 score (Wu & Noé) of a model's
  outputs, ``R_2 = tr(C_00^{-1} C_0t C_tt^{-1} C_0t^T)``, through Cholesky
  solves of the ``eps``-regularised covariances: no ``eigh`` on the
  differentiated path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .losses import _normalized_weights

__all__ = [
    "TICAResult",
    "tica",
    "vamp2_score",
    "vamp2_loss",
    "make_vamp_loss",
]


def _lagged_moments(f0, ft, w):
    """Weighted means and the covariance blocks of the centred legs."""
    m0 = torch.sum(w[:, None] * f0, dim=0)
    mt = torch.sum(w[:, None] * ft, dim=0)
    f0c = f0 - m0
    ftc = ft - mt
    c00 = (f0c * w[:, None]).T @ f0c
    ctt = (ftc * w[:, None]).T @ ftc
    c0t = (f0c * w[:, None]).T @ ftc
    return m0, mt, c00, ctt, c0t


@dataclass
class TICAResult:
    """Linear slow modes of a feature time series.

    eigenvalues ``[k]``: lag-``tau`` autocorrelations, descending. modes
    ``[d, k]``: projection vectors in feature space, ``C_00``-orthonormal.
    mean ``[d]``: the feature mean removed before projecting. lag: the lag,
    in the unit the pairs were sampled at (for :meth:`timescales`).
    """

    eigenvalues: np.ndarray
    modes: np.ndarray
    mean: np.ndarray
    lag: float = 1.0

    def transform(self, f):
        """Project features ``[l, d]`` onto the slow modes ``[l, k]``
        (float64 numpy)."""
        if torch.is_tensor(f):
            f = f.detach().cpu().numpy()
        return (np.asarray(f, np.float64) - self.mean) @ self.modes

    def timescales(self):
        """Implied timescales ``-lag / log(lambda_i)`` (inf for
        lambda >= 1, nan for lambda <= 0)."""
        lam = np.asarray(self.eigenvalues, dtype=np.float64)
        out = np.full(lam.shape, np.nan)
        ok = (lam > 0) & (lam < 1)
        out[ok] = -self.lag / np.log(lam[ok])
        out[lam >= 1] = np.inf
        return out


def tica(f0, ft, *, weights=None, reversible=True, eps=1e-6, lag=1.0,
         n_modes=None):
    """Linear TICA over feature pairs ``(f0 [l, d], ft [l, d])``.

    Solves ``C_0t v = lambda C_00 v`` by symmetric whitening. With
    ``reversible`` (default) means and covariances are pooled over both legs
    and ``C_0t`` symmetrised, which gives real eigenvalues in ``[-1, 1]``
    for equilibrium data; ``reversible=False`` SVDs the whitened
    ``C_0t`` where it is not symmetric. ``weights [l]`` reweight pairs,
    unnormalised. Tensors are taken as they are (detached), arrays as
    float32 on the host.

    Example:
        >>> import numpy as np
        >>> rng = np.random.default_rng(0)
        >>> z = np.zeros((20001, 1), np.float32)
        >>> for t in range(20000):   # AR(1), autocorrelation 0.8
        ...     z[t + 1] = 0.8 * z[t] + np.sqrt(1 - 0.8**2) * rng.normal()
        >>> r = tica(z[:-1], z[1:])
        >>> bool(abs(r.eigenvalues[0] - 0.8) < 0.05)
        True
    """
    f0 = torch.as_tensor(f0).detach().to(torch.float32)
    ft = torch.as_tensor(ft, device=f0.device).detach().to(torch.float32)
    if f0.shape != ft.shape or f0.ndim != 2:
        raise ValueError(
            f"f0/ft must be matching [l, d] arrays, got {tuple(f0.shape)} vs "
            f"{tuple(ft.shape)}")
    w = _normalized_weights(f0.shape[0], weights, f0)
    m0, mt, c00, ctt, c0t = (t.cpu().numpy().astype(np.float64)
                             for t in _lagged_moments(f0, ft, w))

    d = f0.shape[1]
    if reversible:
        # pool the two legs around the common mean; symmetrise C_0t
        mean = 0.5 * (m0 + mt)
        dm0, dmt = m0 - mean, mt - mean
        c0 = 0.5 * (c00 + np.outer(dm0, dm0) + ctt + np.outer(dmt, dmt))
        ct = c0t + np.outer(dm0, dmt)
        ct = 0.5 * (ct + ct.T)
    else:
        mean = m0
        c0, ct = c00, c0t

    s, u = np.linalg.eigh(c0 + eps * np.eye(d))
    keep = s > max(eps, s.max() * 1e-12)
    whiten = u[:, keep] / np.sqrt(s[keep])  # [d, r]
    m = whiten.T @ ct @ whiten              # [r, r]
    if not reversible and not np.allclose(m, m.T, atol=1e-10):
        v, lam, _ = np.linalg.svd(m)
    else:
        lam, v = np.linalg.eigh(m)
        order = np.argsort(lam)[::-1]
        lam, v = lam[order], v[:, order]
    modes = whiten @ v  # C_00-orthonormal directions in feature space
    if n_modes is not None:
        lam, modes = lam[:n_modes], modes[:, :n_modes]
    return TICAResult(
        eigenvalues=np.asarray(lam, np.float64),
        modes=np.asarray(modes, np.float64),
        mean=np.asarray(mean, np.float64),
        lag=float(lag),
    )


def vamp2_score(f0, ft, *, weights=None, eps=1e-6):
    """VAMP-2 score of output pairs ``(f0 [l, k], ft [l, k])``:
    ``tr(C_00^{-1} C_0t C_tt^{-1} C_0t^T)``, the sum of squared singular
    values of the whitened time-lagged covariance of the centred outputs.
    Differentiable everywhere: the inverses are Cholesky solves of the
    ``eps``-regularised covariances."""
    f0 = torch.as_tensor(f0)
    ft = torch.as_tensor(ft, device=f0.device)
    w = _normalized_weights(f0.shape[0], weights, f0)
    _, _, c00, ctt, c0t = _lagged_moments(f0, ft, w)
    eye = torch.eye(f0.shape[1], dtype=f0.dtype, device=f0.device)
    a = torch.cholesky_solve(c0t, torch.linalg.cholesky(c00 + eps * eye))
    b = torch.cholesky_solve(c0t.T, torch.linalg.cholesky(ctt + eps * eye))
    return torch.sum(a * b.T)


def vamp2_loss(model, x_t, x_tau, *, weights=None, eps=1e-6,
               return_aux=False):
    """``-R_2(model(x_t), model(x_tau))``, the trainable VAMP-2 objective
    over time-lagged coordinate pairs; ``weights [l]`` per pair. With
    ``return_aux=True`` also returns ``{"vamp2": R_2, "autocorrelations":
    [k]}``, the symmetrised-TICA eigenvalues of the detached outputs (a
    host solve: a diagnostic, not for every step)."""
    f0 = model(x_t)
    ft = model(x_tau)
    score = vamp2_score(f0, ft, weights=weights, eps=eps)
    if not return_aux:
        return -score
    r = tica(f0.detach(), ft.detach(), weights=weights, eps=eps)
    k = f0.shape[1]
    return -score, {
        "vamp2": score,
        "autocorrelations": torch.as_tensor(r.eigenvalues[:k], dtype=f0.dtype,
                                            device=f0.device),
    }


def make_vamp_loss(**kwargs):
    """``(model, batch) -> scalar`` for :func:`~molann_tpu_torch.train.fit`;
    ``batch`` is ``(x_t, x_tau)`` or ``(x_t, x_tau, weights)``."""

    def loss_fn(model, batch):
        if len(batch) == 3:
            x_t, x_tau, weights = batch
        else:
            (x_t, x_tau), weights = batch, None
        return vamp2_loss(model, x_t, x_tau, weights=weights, **kwargs)

    return loss_fn
