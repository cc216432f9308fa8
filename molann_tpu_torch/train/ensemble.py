"""Deep-ensemble (committee) training: the port of
``molann_tpu/train/ensemble.py``.

A committee of K models of one structure gives the uncertainty signal of
adaptive sampling: its disagreement is small where the training data
constrained every member and large where they extrapolate. The JAX package
stacks the members into one pytree and ``jax.vmap``\\s one compiled step
over them. Here the members run one after another, each with its own
optimizer from :func:`~molann_tpu_torch.train.loop.masked_optimizer`:
``torch.func.vmap`` does not compose with the ``create_graph`` gradients
the eigenfunction and committor losses take. A "stacked" ensemble is the
tuple of its members::

    members = reinitialized_members(model, 5, seed=0)
    result = fit_ensemble(members, loss_fn, batches, num_steps=200,
                          bagging=True)
    mean, std = committee(result.models, x)   # std = disagreement
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from typing import Any

import torch

from ..io.serialize import _to_dict
from ..models.ann import (
    MolANN,
    SequentialNN,
    create_sequential_nn,
    named_tensors,
)
from ..parallel.data_parallel import all_reduce_tensors, broadcast_tensors
from ..parallel.mesh import batch_sharding
from .loop import (
    _check_mesh,
    _collective,
    _model_device,
    _reduce_grads,
    _to_device,
    _zero_grad,
    make_train_step,
    masked_optimizer,
    trainable_mask,
)

__all__ = [
    "stack_models",
    "unstack_model",
    "ensemble_size",
    "ensemble_apply",
    "committee",
    "committee_calibration",
    "calibrated_committee",
    "reinitialized_members",
    "make_ensemble_train_step",
    "fit_ensemble",
    "EnsembleResult",
]


class _Shapes:
    """Stands in for ``io.serialize``'s saver: records an array's shape
    and dtype where the saver stores the array."""

    def array(self, a):
        return [list(a.shape), str(a.dtype)]


def _structure(model):
    """What members must share: the saved structure (layer dims, feature
    spec, static fields, tensor shapes and dtypes)."""
    return json.dumps(_to_dict(model, _Shapes()), sort_keys=True)


def stack_models(models):
    """The committee of ``models`` (at least 2, one structure: the same
    layer dims, feature spec and static fields, differing only in
    parameter values), as a tuple. Raises ``ValueError`` otherwise."""
    models = tuple(models)
    if len(models) < 2:
        raise ValueError("an ensemble needs at least 2 members")
    ref = _structure(models[0])
    for i, m in enumerate(models[1:], start=1):
        if _structure(m) != ref:
            raise ValueError(
                f"ensemble member {i} has a different structure than member "
                "0 (members must share layer dims / feature spec / static "
                "fields and differ only in parameter values)")
    return models


def unstack_model(stacked, i: int):
    """Member ``i`` of a committee."""
    return stacked[i]


def ensemble_size(stacked) -> int:
    """Number of members K of a committee."""
    if len(stacked) == 0:
        raise ValueError("an empty tuple is not an ensemble")
    return len(stacked)


def ensemble_apply(stacked, x):
    """Every member on the same input: ``-> [K, ...]``."""
    return torch.stack([m(x) for m in stacked])


def committee(stacked, x):
    """Committee prediction ``(mean [l, d], std [l, d])`` over members;
    ``std`` is the population std, the disagreement signal."""
    ys = ensemble_apply(stacked, x)
    return torch.mean(ys, dim=0), torch.std(ys, dim=0, correction=0)


def committee_calibration(stacked, x_ref, *, eps=1e-8):
    """The gauge-fixing transform ``(mu, sd, sign)`` of
    :func:`calibrated_committee` on the reference frames ``x_ref``, for a
    consumer that evaluates the reference set once."""
    ys_ref = ensemble_apply(stacked, x_ref)              # [K, m, d]
    mu = ys_ref.mean(dim=1, keepdim=True)
    sd = ys_ref.std(dim=1, keepdim=True, correction=0) + eps
    z_ref = (ys_ref - mu) / sd
    sign = torch.sign(torch.sum(z_ref * z_ref[:1], dim=1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)  # [K, 1, d]
    return mu, sd, sign


def calibrated_committee(stacked, x, x_ref=None, *, eps=1e-8,
                         calibration=None):
    """Gauge-fixed committee ``(mean [l, d], std [l, d])`` for CVs defined
    only up to sign and scale (autoencoder bottlenecks, VAMP and
    eigenfunction modes): each member's output is standardised on the
    reference frames ``x_ref`` and its sign aligned to member 0's there,
    so the std on ``x`` measures disagreement, not parametrisation. Pass
    ``x_ref`` or ``calibration=committee_calibration(stacked, x_ref)``."""
    if calibration is None:
        if x_ref is None:
            raise ValueError("pass x_ref or calibration")
        calibration = committee_calibration(stacked, x_ref, eps=eps)
    mu, sd, sign = calibration
    z = sign * (ensemble_apply(stacked, x) - mu) / sd
    return torch.mean(z, dim=0), torch.std(z, dim=0, correction=0)


def reinitialized_members(model, k: int, *, seed: int = 0):
    """K copies of ``model`` whose MLP parameters are drawn afresh
    (``torch.nn.Linear``'s scheme, the same layer dims) from one
    ``torch.Generator`` seeded with ``seed``, on the model's device. The
    preprocessing layer (alignment, features, the frozen ``ref_x``) is
    shared. Takes a :class:`~molann_tpu_torch.models.ann.SequentialNN`, a
    :class:`~molann_tpu_torch.models.ann.MolANN`, or (nested) tuples of
    them (the ``(model, decoder)`` pairs of the autoencoder losses)."""
    if k < 2:
        raise ValueError("an ensemble needs at least 2 members")
    generator = torch.Generator().manual_seed(seed)

    def reinit(m):
        if isinstance(m, (tuple, list)):
            return tuple(reinit(p) for p in m)
        if isinstance(m, MolANN):
            return MolANN(m.preprocessing_layer, reinit(m.ann_layers))
        if isinstance(m, SequentialNN):
            w = m.layers[0].weight
            return create_sequential_nn(m.layer_dims, m.activation,
                                        generator=generator, dtype=w.dtype,
                                        device=w.device)
        raise TypeError(
            f"cannot reinitialize {type(m).__name__}: expected MolANN, "
            "SequentialNN, or a tuple of those")

    return [reinit(model) for _ in range(k)]


def _map_batch(fn, batch):
    if isinstance(batch, (tuple, list)):
        return tuple(fn(b) for b in batch)
    return fn(batch)


def _batch_length(batch):
    return (batch[0] if isinstance(batch, (tuple, list)) else batch).shape[0]


def _pmean_step(loss_fn, mesh):
    """A member's step on this rank's shard of the batch: its loss and
    gradients averaged over the mesh before the optimizer step (JAX's
    per-shard ``pmean``, not the full-batch loss of ``make_train_step``)."""

    def step(model, opt, batch):
        batch = _to_device(batch, _model_device(model))
        _zero_grad(model)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        _reduce_grads(opt, mesh, mean=True)
        (loss,) = all_reduce_tensors([loss.detach()], mesh, mean=True)
        opt.step()
        return model, opt, loss

    return step


def make_ensemble_train_step(loss_fn, mesh=None, *, batch_mode="shared"):
    """``step(models, opts, batch) -> (models, opts, losses [K])`` updating
    every member, one after another (with ``batch_mode="bagging"``,
    ``step(models, opts, batch, generator)``).

    batch_mode:
      - ``"shared"``: every member takes the same batch;
      - ``"member"``: the batch's arrays carry a leading member axis
        ``[K, l, ...]``, member i trains on slice i;
      - ``"bagging"``: each member trains on a bootstrap resample (with
        replacement) of the shared batch, its indices drawn from
        ``generator`` (a ``torch.Generator`` on the batch's device).

    With ``mesh``, every rank passes the same global batch and takes its
    frames of it (axis 1 with ``"member"``, else axis 0); each member's
    loss and gradients on the rank's shard are averaged over the ranks
    before its update, JAX's per-shard ``pmean``. Bagging resamples within
    each rank's shard: the same generator state on every rank draws the
    same local indices, a stratified bootstrap.
    """
    _check_mesh(mesh)
    if batch_mode not in ("shared", "member", "bagging"):
        raise ValueError(f"unknown batch_mode {batch_mode!r}")
    sharded = _collective(mesh)
    member_step = (_pmean_step(loss_fn, mesh) if sharded
                   else make_train_step(loss_fn))
    frame_dim = 1 if batch_mode == "member" else 0

    def step(models, opts, batch, generator=None):
        if batch_mode == "bagging" and generator is None:
            raise ValueError("batch_mode='bagging' needs a generator")
        if sharded:
            shard = batch_sharding(mesh)
            batch = _map_batch(lambda a: shard(a, frame_dim), batch)
        models, opts, losses = list(models), list(opts), []
        for i, (model, opt) in enumerate(zip(models, opts)):
            if batch_mode == "member":
                mb = _map_batch(lambda a: a[i], batch)
            elif batch_mode == "bagging":
                dev = _model_device(model)
                mb = _map_batch(lambda a: torch.as_tensor(a, device=dev),
                                batch)
                l = _batch_length(mb)
                idx = torch.randint(0, l, (l,), generator=generator,
                                    device=generator.device)
                mb = _map_batch(lambda a: a[idx.to(a.device)], mb)
            else:
                mb = batch
            models[i], opts[i], loss = member_step(model, opt, mb)
            losses.append(loss)
        return tuple(models), opts, torch.stack(losses)

    return step


@dataclass
class EnsembleResult:
    models: Any          # the committee, a tuple of K members
    losses: list         # per step: the K members' losses


def fit_ensemble(models, loss_fn, data_iter, *, optimizer=None, mesh=None,
                 num_steps=None, mask=None, log_every=0, bagging=False,
                 seed=0):
    """Train a committee: each member by its own optimizer, on each batch.

    ``models``: K members of one structure (a list or tuple). ``optimizer``
    is a callable from tensors to a ``torch.optim.Optimizer`` (default
    ``torch.optim.Adam`` at ``lr=1e-3``), built per member over the tensors
    ``mask`` (default :func:`trainable_mask`) marks trainable, so the
    alignment's ``ref_x`` stays frozen. With ``bagging=True`` each member
    trains on its own bootstrap resample of every batch, drawn from one
    ``torch.Generator`` seeded with ``seed`` on the batch's device. Returns
    :class:`EnsembleResult` (the members and the per-member loss trace).
    With ``mesh`` (see :func:`make_ensemble_train_step`), rank 0's members
    are broadcast to every rank first.
    """
    _check_mesh(mesh)
    stacked = stack_models(models)
    if _collective(mesh):
        broadcast_tensors([t for m in stacked for _, t in named_tensors(m)],
                          mesh)
    if optimizer is None:
        optimizer = functools.partial(torch.optim.Adam, lr=1e-3)
    if mask is None:
        mask = trainable_mask(stacked[0])
    build = masked_optimizer(optimizer, mask)
    opts = [build(m) for m in stacked]
    step = make_ensemble_train_step(
        loss_fn, mesh, batch_mode="bagging" if bagging else "shared")
    generator = None
    if bagging:
        generator = torch.Generator(device=_model_device(stacked[0]))
        generator.manual_seed(seed)

    losses = []
    it = iter(data_iter)
    i = 0
    while num_steps is None or i < num_steps:
        batch = next(it, None)
        if batch is None:
            break
        stacked, opts, loss = step(stacked, opts, batch, generator)
        losses.append(loss)
        i += 1
        if log_every and i % log_every == 0:
            print(f"step {i}: loss={float(loss.mean()):.6g} "
                  f"(committee mean)")
    losses = [[float(v) for v in l] for l in losses]
    return EnsembleResult(models=stacked, losses=losses)
