"""Path collective variables: progress along (and distance from) a
reference path in CV space (the port of ``molann_tpu/sampling/pathcv.py``).

The Branduardi-Gervasio-Parrinello path-CV pair (J. Chem. Phys. 126,
054103 (2007)): given images ``z_1..z_m`` along the path,

    s(z) = (1/(m-1)) * sum_i (i-1) w_i / sum_i w_i      (progress, [0, 1])
    t(z) = -(1/lam) * log sum_i w_i                      (tube, ~ dist^2)

with ``w_i = exp(-lam * |z - z_i|^2)``. Biasing ``s`` explores *along* the
transition tube; restraining ``t`` keeps walkers *inside* it. Both are
smooth, so the chain rule through a CV model turns them into atomic
forces like any other CV here.
"""

from __future__ import annotations

import numpy as np
import torch

from .langevin import _DeviceTables, _tensor

__all__ = ["PathCV"]


class PathCV:
    """Smooth progress/tube coordinates for a path of CV-space images.

    images: ``[m >= 2, d]`` ordered path images (e.g. a converged
    string). lam: the Gaussian sharpness ``lam``; default is the
    standard heuristic ``2.3 / <|z_{i+1} - z_i|^2>``. The images are kept
    on the host and put on each device the path is evaluated on, once.

    Example:
        >>> import torch
        >>> p = PathCV(torch.tensor([[0.0], [1.0], [2.0]]))
        >>> s, t = p(torch.tensor([[1.0], [2.0]]))
        >>> bool(abs(s[0] - 0.5) < 1e-6) and bool(abs(t[0]) < 0.1)
        True
        >>> bool(s[1] > 0.8)  # at the last image: near full progress
        True
    """

    def __init__(self, images, lam=None):
        imgs = (images.detach().cpu().numpy() if isinstance(images,
                                                            torch.Tensor)
                else np.asarray(images)).astype(np.float32)
        if imgs.ndim != 2 or imgs.shape[0] < 2:
            raise ValueError(
                f"images must be [m >= 2, d], got {imgs.shape}"
            )
        seg2 = ((np.diff(imgs, axis=0) ** 2).sum(axis=1))
        if not (seg2 > 0).all():
            raise ValueError("path images must be pairwise distinct "
                             "(zero-length segment found)")
        self.images = torch.as_tensor(imgs)
        self.lam = float(2.3 / seg2.mean() if lam is None else lam)
        if self.lam <= 0:
            raise ValueError(f"lam must be > 0, got {self.lam}")
        m = imgs.shape[0]
        self._tables = _DeviceTables(
            images=imgs, frac=np.arange(m, dtype=np.float32) / np.float32(
                m - 1))

    @classmethod
    def from_mep(cls, path, lam=None):
        """Build from a ``mep --out`` file: ``.npy`` of ``[m, d+1]``
        (images + free-energy column, dropped here) or the equivalent
        ``.csv``."""
        if str(path).endswith(".csv"):
            arr = np.loadtxt(path, delimiter=",", skiprows=1,
                             dtype=np.float64)
        else:
            arr = np.load(path)
        arr = np.atleast_2d(arr)
        if arr.shape[1] < 2:
            raise ValueError(
                f"a mep output has >= 2 columns (cv..., free_energy); "
                f"got shape {arr.shape}"
            )
        return cls(arr[:, :-1], lam=lam)

    def __call__(self, z):
        """``z [W, d] -> (s [W], t [W])``: progress in [0, 1] and tube
        distance (units of CV distance squared; on the path itself t is
        slightly NEGATIVE, ``-log(1 + 2 e^-2.3)/lam`` at the default
        sharpness — only differences of t matter for restraints)."""
        z = _tensor(z)
        squeeze = z.ndim == 1
        if squeeze:
            z = z[None]
        tab = self._tables.on(z.device)
        images, frac = tab["images"], tab["frac"]
        d2 = torch.sum((z[:, None, :] - images[None, :, :]) ** 2, dim=-1)
        d2min = torch.amin(d2, dim=1, keepdim=True)
        w = torch.exp(-self.lam * (d2 - d2min))  # stabilized, max entry = 1
        denom = torch.sum(w, dim=1)
        s = torch.sum(w * frac[None, :], dim=1) / denom
        t = d2min[:, 0] - torch.log(denom) / self.lam
        return (s[0], t[0]) if squeeze else (s, t)

    def progress(self, z):
        """Just ``s(z) [W]`` (see :meth:`__call__`)."""
        return self(z)[0]

    def tube(self, z):
        """Just ``t(z) [W]`` (see :meth:`__call__`)."""
        return self(z)[1]

    def along(self, cv_model):
        """Compose with a CV model: returns ``x [W, n, 3] -> s [W, 1]``,
        a drop-in ``cv_model`` for the biasing integrators."""

        def path_progress(x):
            return self.progress(cv_model(x))[:, None]

        return path_progress

    def wall(self, cv_model, *, k_wall, t_max):
        """Half-harmonic tube restraint ``0.5 k (t - t_max)^2`` for
        ``t > t_max`` (zero inside): returns ``x [W, n, 3] -> [W]``, an
        energy term to ADD to the physical potential."""
        if k_wall < 0:
            raise ValueError(f"k_wall must be >= 0, got {k_wall}")

        def wall_energy(x):
            t = self.tube(cv_model(x))
            excess = torch.clamp(t - float(t_max), min=0.0)
            return 0.5 * float(k_wall) * excess * excess

        return wall_energy
