"""Discriminant CV estimation from labelled metastable states: the port of
``molann_tpu/train/discriminant.py``, carried over rather than imported
(numpy only; importing any ``molann_tpu`` module imports JAX).

:func:`hlda` is harmonic linear discriminant analysis (Mendels, Piccini &
Parrinello, JPCL 9, 2776 (2018)): Fisher's ratio of between-class to
within-class scatter, with the class covariances averaged harmonically
(``S_w = (sum_c Sigma_c^{-1})^{-1}``), so that a tight basin pins the
direction more than a floppy one; ``harmonic=False`` is Fisher LDA. Feed
it features from the model (a ``FeatureLayer`` on the card, brought over
as numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["HLDAResult", "hlda"]


@dataclass
class HLDAResult:
    """Linear discriminant CVs from labeled states.

    directions ``[d, k]``: discriminant vectors in feature space
    (columns, unit norm, descending separation); eigenvalues ``[k]``:
    between/within scatter ratios; mean ``[d]``: global feature mean
    removed before projecting; class_means ``[K, d]``; classes ``[K]``:
    the label value each row corresponds to.
    """

    directions: np.ndarray
    eigenvalues: np.ndarray
    mean: np.ndarray
    class_means: np.ndarray
    classes: np.ndarray

    def transform(self, f):
        """Project features ``[l, d]`` onto the discriminants
        ``[l, k]``."""
        return (np.asarray(f, np.float64) - self.mean) @ self.directions


def hlda(features, labels, *, harmonic=True, shrinkage=1e-6,
         n_components=None):
    """Harmonic (or Fisher) linear discriminant CVs.

    features ``[l, d]``: feature vectors (e.g. a
    :class:`~molann_tpu_torch.models.ann.FeatureLayer` applied to short
    unbiased runs in each basin). labels ``[l]``: integer state labels
    (any values; each must appear at least ``d+1`` times for a usable
    covariance). shrinkage: ridge added to each class covariance
    (fractional — scaled by the mean diagonal). Returns
    :class:`HLDAResult` with ``min(K-1, d)`` components (or
    ``n_components``).

    Example:
        >>> import numpy as np
        >>> rng = np.random.default_rng(0)
        >>> a = rng.normal(size=(4000, 2)) * [0.1, 1.0]
        >>> b = rng.normal(size=(4000, 2)) * [0.1, 1.0] + [1.0, 0.0]
        >>> f = np.concatenate([a, b])
        >>> lab = np.repeat([0, 1], 4000)
        >>> w = hlda(f, lab).directions[:, 0]
        >>> bool(abs(w[0]) > 30 * abs(w[1]))  # separates along axis 0
        True
    """
    f = np.asarray(features, np.float64)
    y = np.asarray(labels).reshape(-1)
    if f.ndim != 2 or f.shape[0] != y.shape[0]:
        raise ValueError(
            f"features must be [l, d] with one label per row, got "
            f"{f.shape} vs {y.shape}"
        )
    classes = np.unique(y)
    k_cls = len(classes)
    d = f.shape[1]
    if k_cls < 2:
        raise ValueError("need at least 2 distinct labels")

    mu = f.mean(axis=0)
    class_means = np.empty((k_cls, d))
    s_b = np.zeros((d, d))
    covs = []
    for i, c in enumerate(classes):
        fc = f[y == c]
        if fc.shape[0] < d + 1:
            raise ValueError(
                f"class {c!r} has only {fc.shape[0]} samples; need more "
                f"than the feature dimension ({d}) for a covariance"
            )
        class_means[i] = fc.mean(axis=0)
        dm = class_means[i] - mu
        s_b += (fc.shape[0] / f.shape[0]) * np.outer(dm, dm)
        cov = np.cov(fc.T, bias=False).reshape(d, d)
        cov += shrinkage * max(np.trace(cov) / d, 1e-300) * np.eye(d)
        covs.append(cov)

    if harmonic:
        # S_w^{-1} directly: the harmonic average weights tight basins up
        s_w_inv = sum(np.linalg.inv(c) for c in covs)
    else:
        s_w_inv = np.linalg.inv(sum(covs))

    # maximize w'S_b w / w'S_w w with S_w = s_w_inv^{-1}: substitute
    # w = L u where s_w_inv = L L' -> plain symmetric eigh
    ell = np.linalg.cholesky(s_w_inv)
    lam, u = np.linalg.eigh(ell.T @ s_b @ ell)
    order = np.argsort(lam)[::-1]
    k = min(k_cls - 1, d) if n_components is None else int(n_components)
    w = ell @ u[:, order[:k]]
    w = w / np.linalg.norm(w, axis=0, keepdims=True)
    return HLDAResult(
        directions=w,
        eigenvalues=lam[order[:k]],
        mean=mu,
        class_means=class_means,
        classes=classes,
    )
