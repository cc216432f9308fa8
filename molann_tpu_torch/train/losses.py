"""Losses for collective-variable training over ``(model, batch)``.

The port of ``molann_tpu/train/losses.py``: supervised MSE regression
(eager and through the fused kernels) and three CV-learning objectives
(reference README.rst:51, "adaptive learning of reaction coordinates"):
the autoencoder reconstruction losses, the variational
generator-eigenfunction loss and the variational committor loss. The
objectives run through the eager model: their coordinate gradients come
from ``torch.autograd.grad`` with ``create_graph``, so that the loss's
parameter gradient (second order) follows by one more backward pass. They
launch no fused kernel. Every tensor a loss makes lies on the frames'
device.
"""

from __future__ import annotations

import torch

from ..ops.fused import fused_model_forward

__all__ = [
    "mse_loss",
    "fused_mse_loss",
    "autoencoder_loss",
    "timelagged_autoencoder_loss",
    "cv_coordinate_gradients",
    "eigenfunction_loss",
    "make_eigenfunction_loss",
    "committor_loss",
    "make_committor_loss",
    "registry",
]


def mse_loss(model, batch):
    """Supervised regression through the eager model: batch = ``(x [l, n,
    3], y [l, d])`` tensors."""
    x, y = batch
    return torch.mean((model(x) - y) ** 2)


def fused_mse_loss(model, batch, *, interpret=False):
    """:func:`mse_loss` through the fused path: on the card the forward
    kernel, and under autograd the backward kernel (the unrolled or the
    blocked pair, by the system's size). x may be packed ``[l, 3n]``."""
    x, y = batch
    pred = fused_model_forward(model, x, interpret=interpret)
    return torch.mean((pred - y) ** 2)


def _normalized_weights(l, weights, like):
    """Per-frame weights summing to one, on ``like``'s device and dtype:
    uniform when ``weights`` is None."""
    if weights is None:
        return torch.full((l,), 1.0 / l, dtype=like.dtype, device=like.device)
    w = torch.as_tensor(weights, dtype=like.dtype, device=like.device)
    return w / torch.sum(w)


def _weighted_mean(err, weights):
    if weights is None:
        return torch.mean(err)
    w = torch.as_tensor(weights, dtype=err.dtype, device=err.device)
    return torch.sum(err * w) / torch.sum(w)


def autoencoder_loss(encoder, decoder, preprocessing, x, weights=None):
    """Autoencoder CV loss in feature space: ``f = preprocessing(x)``,
    ``z = encoder(f)``, ``f̂ = decoder(z)``; the (weighted) mean over
    frames of ``‖f̂ − f‖²``."""
    f = preprocessing(x)
    rec = decoder(encoder(f))
    return _weighted_mean(torch.sum((rec - f) ** 2, dim=1), weights)


def timelagged_autoencoder_loss(encoder, decoder, preprocessing, x_t,
                                x_tau, weights=None):
    """Time-lagged autoencoder (TAE) CV loss: the decoder reconstructs the
    features a lag LATER, the (weighted) mean of
    ``‖decoder(encoder(pp(x_t))) − pp(x_tau)‖²`` over lagged pairs
    (Wehmeyer & Noé, J. Chem. Phys. 148, 241703 (2018)).

    Example:
        >>> import torch
        >>> from molann_tpu_torch.models.ann import create_sequential_nn
        >>> enc = create_sequential_nn([6, 1])
        >>> dec = create_sequential_nn([1, 6])
        >>> pp = lambda x: x.reshape(x.shape[0], -1)
        >>> x = torch.randn(17, 2, 3, generator=torch.Generator().manual_seed(2))
        >>> float(timelagged_autoencoder_loss(
        ...     enc, dec, pp, x[:-1], x[1:])) > 0
        True
    """
    rec = decoder(encoder(preprocessing(x_t)))
    err = torch.sum((rec - preprocessing(x_tau)) ** 2, dim=1)
    return _weighted_mean(err, weights)


def _values_and_gradients(model, x):
    """``(f [l, k], grads [k, l, n, 3])``: the model's outputs and, per
    output component, the per-frame coordinate gradients, from ``k``
    backward passes of the batched model (frames are independent, so the
    batch-summed gradient of one component is its per-frame gradient).

    The gradients keep their graph (``create_graph``) while grad mode is on,
    so a loss over them can be differentiated once more."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_(True)
        f = model(xg)
        k = f.shape[1]
        grads = []
        for i in range(k):
            ct = torch.zeros_like(f)
            ct[:, i] = 1.0
            (g,) = torch.autograd.grad(f, xg, ct, retain_graph=True,
                                       create_graph=create)
            grads.append(g)
    grads = torch.stack(grads)
    if not create:
        f, grads = f.detach(), grads.detach()
    return f, grads


def cv_coordinate_gradients(model, x):
    """Per-frame coordinate gradients of every CV component at once:
    ``x [l, n, 3] -> [k, l, n, 3]``, ``out[i, f] = ∂model(x)[f, i]/∂x[f]``,
    from ``k`` backward passes of the batched model. Differentiable once
    more while grad mode is on.

    Example:
        >>> import torch
        >>> from molann_tpu_torch.models.ann import create_sequential_nn
        >>> mlp = create_sequential_nn([6, 8, 2])
        >>> model = lambda x: mlp(x.reshape(x.shape[0], -1))
        >>> x = torch.randn(16, 2, 3, generator=torch.Generator().manual_seed(1))
        >>> tuple(cv_coordinate_gradients(model, x).shape)
        (2, 16, 2, 3)
    """
    return _values_and_gradients(model, x)[1]


def eigenfunction_loss(model, x, *, beta=1.0, alpha=10.0,
                       eig_weights=None, weights=None, return_aux=False):
    """Variational loss for eigenfunctions of the overdamped-Langevin
    generator.

    For ``k`` outputs on frames from (or reweighted by ``weights`` to) the
    Boltzmann measure at inverse temperature ``beta``: the Rayleigh
    quotients ``E_i = (1/beta)·E_w[|∇f_i|²]``, and
    ``loss = Σ_i ω_i E_i + alpha·Σ_{i≤j} (⟨f_i, f_j⟩ − δ_ij)²`` with
    ``⟨·,·⟩`` the weighted covariance of the centred outputs and ``ω``
    (``eig_weights``, default ``k, k-1, …, 1``) decreasing, so that output
    0 learns the slowest mode. With ``return_aux=True`` also returns
    ``{"eigenvalues": [k], "cov": [k, k]}``, the Rayleigh quotients over
    the realised variances.

    Example:
        >>> import torch
        >>> from molann_tpu_torch.models.ann import create_sequential_nn
        >>> mlp = create_sequential_nn([6, 8, 2])
        >>> model = lambda x: mlp(x.reshape(x.shape[0], -1))
        >>> x = torch.randn(64, 2, 3, generator=torch.Generator().manual_seed(1))
        >>> loss, aux = eigenfunction_loss(model, x, beta=2.0,
        ...                                return_aux=True)
        >>> bool(torch.isfinite(loss))
        True
        >>> tuple(aux["eigenvalues"].shape), tuple(aux["cov"].shape)
        ((2,), (2, 2))
    """
    f, grads = _values_and_gradients(model, x)  # [l, k], [k, l, n, 3]
    l, k = f.shape
    w = _normalized_weights(l, weights, f)
    if eig_weights is None:
        eig_weights = torch.arange(k, 0, -1, dtype=f.dtype, device=f.device)
    else:
        eig_weights = torch.as_tensor(eig_weights, dtype=f.dtype,
                                      device=f.device)

    fc = f - torch.sum(w[:, None] * f, dim=0)
    cov = (fc * w[:, None]).T @ fc  # [k, k]
    gsq = torch.sum(grads * grads, dim=(2, 3))  # [k, l]
    rayleigh = torch.sum(gsq * w[None, :], dim=1) / beta  # [k]

    delta = cov - torch.eye(k, dtype=f.dtype, device=f.device)
    # i <= j once each: the full Frobenius sum counts off-diagonals twice
    penalty = 0.5 * (torch.sum(delta * delta)
                     + torch.sum(torch.diagonal(delta) ** 2))
    loss = torch.sum(eig_weights * rayleigh) + alpha * penalty
    if return_aux:
        var = torch.clamp(torch.diagonal(cov), min=1e-12)
        return loss, {"eigenvalues": rayleigh / var, "cov": cov}
    return loss


def committor_loss(model, x, labels, *, beta=1.0, alpha=100.0,
                   component=0, weights=None, return_aux=False):
    """Variational committor loss (Li, Lin & Ren, deep committor).

    ``q = sigmoid(model(x)[:, component])``;
    ``loss = E_w[|∇q|²]/beta + alpha·(E_w[q² | A] + E_w[(1−q)² | B])``.
    ``labels [l]``: 1 = A (reactant), 2 = B (product), 0 = neither.
    ``weights [l]`` reweight to the Boltzmann measure, unnormalised. A
    batch missing a basin adds zero for its penalty. With
    ``return_aux=True`` also returns ``{"dirichlet", "mean_q_a",
    "mean_q_b"}``.

    Example:
        >>> import torch
        >>> from molann_tpu_torch.models.ann import create_sequential_nn
        >>> mlp = create_sequential_nn([6, 8, 1])
        >>> model = lambda x: mlp(x.reshape(x.shape[0], -1))
        >>> x = torch.randn(32, 2, 3, generator=torch.Generator().manual_seed(1))
        >>> labels = torch.tensor([1] * 10 + [0] * 12 + [2] * 10)
        >>> loss, aux = committor_loss(model, x, labels, return_aux=True)
        >>> bool(torch.isfinite(loss)), sorted(aux)
        (True, ['dirichlet', 'mean_q_a', 'mean_q_b'])
    """
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        q = torch.sigmoid(model(xg)[:, component])
        # frames are independent: the batch-summed gradient is the
        # per-frame gradient, one backward pass for the whole batch
        (g,) = torch.autograd.grad(torch.sum(q), xg, create_graph=create)
    if not create:
        q, g = q.detach(), g.detach()
    gsq = torch.sum(g * g, dim=tuple(range(1, g.ndim)))  # [l]

    w = _normalized_weights(q.shape[0], weights, q)
    labels = torch.as_tensor(labels, device=q.device)
    in_a = (labels == 1).to(q.dtype)
    in_b = (labels == 2).to(q.dtype)
    dirichlet = torch.sum(w * gsq) / beta

    def conditional(mask, vals):
        mass = torch.sum(w * mask)
        # the inner where keeps the untaken branch finite, so that its
        # gradient (0 times the quotient's) is 0 and not NaN
        safe = torch.where(mass > 0, mass, torch.ones_like(mass))
        return torch.where(mass > 0, torch.sum(w * mask * vals) / safe,
                           torch.zeros_like(mass))

    pen_a = conditional(in_a, q ** 2)
    pen_b = conditional(in_b, (1.0 - q) ** 2)
    loss = dirichlet + alpha * (pen_a + pen_b)
    if return_aux:
        return loss, {
            "dirichlet": dirichlet,
            "mean_q_a": conditional(in_a, q),
            "mean_q_b": conditional(in_b, q),
        }
    return loss


def make_committor_loss(**kwargs):
    """``(model, batch) -> scalar`` for :func:`~molann_tpu_torch.train.fit`;
    ``batch`` is ``(x, labels)`` or ``(x, labels, weights)``."""

    def loss_fn(model, batch):
        if len(batch) == 3:
            x, labels, weights = batch
        else:
            (x, labels), weights = batch, None
        return committor_loss(model, x, labels, weights=weights, **kwargs)

    return loss_fn


def make_eigenfunction_loss(**kwargs):
    """``(model, batch) -> scalar`` for :func:`~molann_tpu_torch.train.fit`;
    ``batch`` is ``x`` or ``(x, weights)``."""

    def loss_fn(model, batch):
        if isinstance(batch, (tuple, list)):
            x, weights = batch
        else:
            x, weights = batch, None
        return eigenfunction_loss(model, x, weights=weights, **kwargs)

    return loss_fn


def _vamp_default(model, batch):
    from .timelagged import make_vamp_loss

    return make_vamp_loss()(model, batch)


registry = {
    "mse": mse_loss,
    "fused_mse": fused_mse_loss,
    "eigenfunction": make_eigenfunction_loss(),
    "committor": make_committor_loss(),
    "vamp": _vamp_default,
}
