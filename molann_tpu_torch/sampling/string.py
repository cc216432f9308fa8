"""Minimum free-energy paths: the simplified string method in CV space
(the port of ``molann_tpu/sampling/string.py``).

The simplified string method (E, Ren, Vanden-Eijnden, J. Chem. Phys. 126,
164103 (2007)): evolve a chain of images by steepest descent on the
(free-)energy and reparametrize to equal arc length each step; the
converged string is the minimum (free-)energy path, its interior maxima
are the saddle points. The relaxation is a loop of vectorized image
updates on the images' device (images ride the batch axis), and the
energy can be any differentiable ``[m, d] -> [m]`` function — an analytic
potential, a reconstructed FES through :func:`grid_interpolator`, or a
saved bias.
"""

from __future__ import annotations

import numpy as np
import torch

from .langevin import _DeviceTables, _tensor

__all__ = ["string_method", "grid_interpolator", "linear_path"]


def linear_path(a, b, n_images):
    """Straight-line initial string from ``a`` to ``b`` (``[n_images, d]``,
    on the device of ``a``)."""
    a = _tensor(a)
    b = _tensor(b, like=a)
    t = torch.linspace(0.0, 1.0, n_images, dtype=torch.float32,
                       device=a.device)[:, None]
    return (1.0 - t) * a + t * b


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for 1-D tensors: the same segment search,
    the same guard of a zero-length segment and the same clamping."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _reparametrize(imgs):
    """Redistribute images to equal arc length along the piecewise-linear
    string (per-dimension interpolation over normalized arc length)."""
    seg = torch.linalg.vector_norm(torch.diff(imgs, dim=0), dim=1)
    s = torch.cat([torch.zeros(1, dtype=imgs.dtype, device=imgs.device),
                   torch.cumsum(seg, dim=0)])
    s = s / torch.clamp(s[-1], min=1e-30)
    t = torch.linspace(0.0, 1.0, imgs.shape[0], dtype=imgs.dtype,
                       device=imgs.device)
    return torch.stack([_interp(t, s, imgs[:, k])
                        for k in range(imgs.shape[1])], dim=1)


def string_method(energy_fn, init_images, *, n_iterations=2000, step=1e-3,
                  pin_ends=False):
    """Relax a string of images to the minimum (free-)energy path.

    energy_fn: differentiable ``[m, d] -> [m]`` (e.g. from
    :func:`grid_interpolator`, or an analytic CV-space potential).
    init_images: ``[m, d]`` starting string (see :func:`linear_path`).
    step: steepest-descent step size (same units as ``cv^2/energy``).
    pin_ends: keep the two endpoints fixed; default False lets them
    slide into their local minima (the standard simplified string).

    Returns ``(images [m, d], energies [m])`` — interior maxima of
    ``energies`` locate the transition states.

    Example:
        >>> import torch
        >>> quad = lambda z: torch.sum((z * z - 1.0) ** 2, dim=-1)
        >>> s0 = linear_path(torch.tensor([-1.0, -1.0]), [1.0, 1.0], 11)
        >>> imgs, e = string_method(quad, s0, n_iterations=500, step=2e-2)
        >>> bool(torch.all(torch.abs(torch.abs(imgs[0]) - 1.0) < 1e-2))
        True
    """
    imgs = _tensor(init_images)
    if imgs.ndim != 2 or imgs.shape[0] < 3:
        raise ValueError(
            f"init_images must be [n_images >= 3, d], got "
            f"{tuple(imgs.shape)}"
        )
    step = float(step)
    for _ in range(int(n_iterations)):
        with torch.enable_grad():
            z = imgs.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(torch.sum(energy_fn(z)), z)
        moved = imgs - step * g
        if pin_ends:
            moved[0] = imgs[0]
            moved[-1] = imgs[-1]
        imgs = _reparametrize(moved)
    with torch.no_grad():
        return imgs, energy_fn(imgs)


def grid_interpolator(mids, values, *, fill=None):
    """Differentiable multilinear interpolation of a gridded function —
    turns a reconstructed FES grid (``fes`` / ``pmf``) into the
    ``[m, d] -> [m]`` energy the string method needs.

    mids: sequence of ``d`` 1-D arrays of UNIFORMLY-spaced grid-cell
    midpoints. values: ``[len(mids[0]), ..., len(mids[d-1])]`` grid of
    function values. Queries are clamped to the grid hull; ``fill`` (if
    given) replaces non-finite grid cells (empty FES bins) before
    interpolation.

    Returns ``f(z [m, d]) -> [m]``, evaluated on the device of ``z``.
    """
    mids = [np.asarray(m.detach().cpu() if isinstance(m, torch.Tensor)
                       else m, np.float64) for m in mids]
    vals = np.array(values.detach().cpu() if isinstance(values, torch.Tensor)
                    else values, np.float64)
    if vals.shape != tuple(len(m) for m in mids):
        raise ValueError(
            f"values shape {vals.shape} != grid shape "
            f"{tuple(len(m) for m in mids)}"
        )
    for m in mids:
        if len(m) < 2:
            raise ValueError("each grid axis needs >= 2 points")
        dm = np.diff(m)
        if not np.allclose(dm, dm[0], rtol=1e-4):
            raise ValueError("grid midpoints must be uniformly spaced")
    if fill is not None:
        vals = np.where(np.isfinite(vals), vals, float(fill))
    elif not np.isfinite(vals).all():
        raise ValueError(
            "values contain non-finite cells (empty FES bins); pass "
            "fill= to replace them"
        )
    d = len(mids)
    tables = _DeviceTables(
        lo=np.asarray([m[0] for m in mids], np.float32),
        dx=np.asarray([m[1] - m[0] for m in mids], np.float32),
        nn=np.asarray([len(m) for m in mids], np.int64),
        table=vals.astype(np.float32).reshape(-1),
        # all 2^d corner offsets of the containing cell
        corners=np.asarray(
            [[(c >> k) & 1 for k in range(d)] for c in range(2 ** d)],
            np.int64))
    sizes = [len(m) for m in mids]

    def f(z):
        z = _tensor(z)
        squeeze = z.ndim == 1
        if squeeze:
            z = z[None]
        t = tables.on(z.device)
        nn = t["nn"]
        u = (z - t["lo"]) / t["dx"]           # fractional grid coords [m,d]
        u = torch.minimum(torch.clamp(u, min=0.0), (nn - 1).to(torch.float32))
        i0 = torch.minimum(torch.clamp(torch.floor(u).to(torch.int64), min=0),
                           nn - 2)             # [m, d]
        w = u - i0.to(torch.float32)           # in-cell weights [m, d]
        out = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
        for c in range(2 ** d):
            offset = t["corners"][c]
            idx = i0 + offset                  # [m, d]
            cw = torch.prod(torch.where(offset == 1, w, 1.0 - w), dim=1)
            flat = torch.zeros(z.shape[0], dtype=torch.int64,
                               device=z.device)
            for k in range(d):                 # static tiny loop over dims
                flat = flat * sizes[k] + idx[:, k]
            out = out + cw * t["table"][flat]
        return out[0] if squeeze else out

    return f
