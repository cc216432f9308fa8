"""Training loop on ``torch.optim``: the port of ``molann_tpu/train/loop.py``.

optax becomes ``torch.optim``. An *optimizer* here is a callable from a list
of tensors to a ``torch.optim.Optimizer`` (``torch.optim.Adam`` itself, or
``functools.partial(torch.optim.Adam, lr=1e-3)``); :func:`masked_optimizer`
builds it over the model's trainable tensors only, which is what the JAX
package's ``optax.multi_transform`` mask does. The optimizer instance then
travels through the step in the place of optax's ``opt_state``::

    opt = masked_optimizer(torch.optim.Adam, trainable_mask(model))(model)
    step = make_fused_train_step()
    model, opt, loss = step(model, opt, (x, y))

The alignment reference ``ref_x`` is a buffer, frozen by the default mask,
as it is in the reference (molann/ann.py:137). A step updates the model in
place. A model may be a tuple of modules, such as the ``(model, decoder)``
pair the autoencoder losses train, as JAX's ``fit`` trains a pytree: its
tensors are named by :func:`~molann_tpu_torch.models.ann.named_tensors`.
A batch is a tuple of arrays or one array.

``mesh=`` (a :func:`~molann_tpu_torch.parallel.data_mesh`) trains data
parallel: every rank runs the step on the same global batch and its own
rows of it, parameters replicated. :func:`make_train_step` computes the
full-batch loss, exactly, as JAX's GSPMD step does: the loss is handed a
:class:`~molann_tpu_torch.parallel.data_parallel.ShardedModel`, whose calls
run this rank's rows and gather every rank's outputs, so the batch moments
of the eigenfunction, committor, VAMP-2 and autoencoder losses are global;
each parameter's gradient is then this rank's part of it, and one
``all_reduce(SUM)`` makes it whole. :func:`make_fused_train_step` follows
JAX's explicit SPMD: the train kernel on this rank's frames, then the loss
and the gradients averaged over the ranks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..models.ann import named_tensors
from ..ops.fused import fused_train_grads
from ..parallel.data_parallel import (
    all_reduce_tensors,
    barrier,
    broadcast_tensors,
    psum_mean_grads,
    sharded_model,
)
from ..parallel.mesh import batch_sharding
from ..parallel.mesh import check_mesh as _check_mesh
from .checkpoint import (
    latest_checkpoint,
    load_training_state,
    save_training_state,
)

__all__ = [
    "trainable_mask",
    "masked_optimizer",
    "make_train_step",
    "make_fused_train_step",
    "fit",
    "TrainResult",
]


def _collective(mesh):
    """True where the step runs collectives over ``mesh``."""
    return mesh is not None and mesh.group is not None


def _reduce_grads(opt, mesh, *, mean):
    """Sum (or average) over ``mesh`` the gradients the optimizer's
    tensors hold, by one all-reduce, in the optimizer's order."""
    held = [p for g in opt.param_groups for p in g["params"]
            if p.grad is not None]
    for p, g in zip(held, all_reduce_tensors([p.grad for p in held], mesh,
                                             mean=mean)):
        p.grad = g


def _model_device(model):
    for _, t in named_tensors(model):
        return t.device
    return torch.device("cpu")


def _to_device(batch, device):
    """A batch on ``device``: a tuple or list of arrays element by element,
    and one array (the bare ``x`` of the eigenfunction loss) whole."""
    if isinstance(batch, (tuple, list)):
        return tuple(torch.as_tensor(b, device=device) for b in batch)
    return torch.as_tensor(batch, device=device)


def _zero_grad(model):
    for _, t in named_tensors(model):
        t.grad = None


def trainable_mask(model, predicate: Callable | None = None):
    """``{name: bool}`` over :func:`named_tensors`, True where trainable.

    Default policy: tensors reached through ``ann_layers`` or ``layers``
    (the MLP weights) are trainable; everything else (the alignment
    ``ref_x`` buffer) is frozen. ``predicate(name, tensor)`` overrides it.
    """
    if predicate is None:
        def predicate(name, tensor):
            return bool({"ann_layers", "layers"} & set(name.split(".")))

    return {name: bool(predicate(name, t)) for name, t in named_tensors(model)}


def masked_optimizer(optimizer, mask):
    """``build(model) -> torch.optim.Optimizer``: ``optimizer`` over the
    tensors that ``mask`` marks True; the rest stay as they are. A buffer
    marked trainable (``ref_x``) is made to require grad."""

    def build(model):
        tensors = dict(named_tensors(model))
        unknown = sorted(set(mask) - set(tensors))
        if unknown:
            raise ValueError(f"mask names tensors the model lacks: {unknown}")
        chosen = []
        for name, t in tensors.items():
            if mask.get(name, False):
                chosen.append(t.requires_grad_(True))
        return optimizer(chosen)

    return build


def make_train_step(loss_fn, mesh=None):
    """``step(model, opt, batch) -> (model, opt, loss)``: autograd of
    ``loss_fn(model, batch)``, then ``opt.step()``. The batch's arrays
    move to the model's device; ``loss`` is a detached 0-d tensor.

    With ``mesh``, every rank passes the same global batch and gets the
    full-batch loss (see the module's docstring): ``loss_fn`` must reach
    the parameters through calls of the model, or of its modules, on
    tensors whose leading dimension is the batch's (a multiple of the mesh
    size)."""
    _check_mesh(mesh)
    sharded = _collective(mesh)

    def step(model, opt, batch):
        batch = _to_device(batch, _model_device(model))
        _zero_grad(model)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(sharded_model(model, mesh) if sharded else model,
                       batch)
        loss.backward()
        if sharded:
            _reduce_grads(opt, mesh, mean=False)
        opt.step()
        return model, opt, loss.detach()

    return step


def make_fused_train_step(mesh=None, *, tile=None, transposed_input=False,
                          interpret=False, mode="auto", precision="auto",
                          train_ref=False):
    """An MSE training step on the single-kernel fused path.

    Like :func:`make_train_step` with ``loss_fn=mse_loss``, but the loss
    AND the gradients come from :func:`~molann_tpu_torch.ops.fused.fused_train_grads`
    (on the card: one launch of the train kernel, the unrolled or the
    blocked one by the system's size under ``mode="auto"``, no coordinate
    gradients). Batch = ``(x, y)``; with ``transposed_input``, ``x [3n, l]``
    and ``y [d, l]``. A blocked system's pair operand is built from the
    model and cached. ``precision`` is resolved for training and otherwise
    ignored: the kernels compute in f32.

    With ``mesh``, every rank passes the same global batch and runs the
    train kernel on its frames (the last dimension with
    ``transposed_input``), and the loss and the gradients are averaged
    over the ranks before the replicated optimizer step, as JAX's
    ``shard_map`` step does."""
    _check_mesh(mesh)
    sharded = _collective(mesh)
    frame_dim = -1 if transposed_input else 0

    def step(model, opt, batch):
        x, y = batch
        if sharded:
            shard = batch_sharding(mesh)
            x, y = shard(x, frame_dim), shard(y, frame_dim)
        x, y = _to_device((x, y), _model_device(model))
        loss, grads = fused_train_grads(
            model, x, y, tile=tile, interpret=interpret,
            transposed_input=transposed_input, mode=mode,
            precision=precision, train_ref=train_ref)
        if sharded:
            (loss,) = all_reduce_tensors([loss], mesh, mean=True)
            grads = psum_mean_grads(grads, mesh)
        names = {id(t): name for name, t in named_tensors(model)}
        for group in opt.param_groups:
            for p in group["params"]:
                p.grad = grads[names[id(p)]].to(p.dtype)
        opt.step()
        return model, opt, loss.detach()

    return step


@dataclass
class TrainResult:
    model: Any
    losses: list


def fit(model, loss_fn, data_iter, *, optimizer=None, mesh=None,
        num_steps=None, mask=None, log_every=0, checkpoint_dir=None,
        checkpoint_every=0, resume=True):
    """Train ``model`` with ``loss_fn(model, batch)`` over ``data_iter``.

    ``optimizer``: a callable from tensors to a ``torch.optim.Optimizer``,
    by default ``torch.optim.Adam`` with ``lr=1e-3`` (the update of
    ``optax.adam(1e-3)``). It is built over the tensors that ``mask``
    (default :func:`trainable_mask`) marks trainable. With
    ``checkpoint_dir``, the model, the optimizer state and the step are
    saved every ``checkpoint_every`` steps and, if ``resume``, training
    continues from the newest checkpoint there, with ``data_iter``
    fast-forwarded past the batches already seen. Returns
    :class:`TrainResult` with the trained model (the checkpoint's model
    after a resume) and the loss trace.

    With ``mesh``, every rank runs ``fit`` on the same global batches and
    takes its rows of each (:func:`make_train_step`); rank 0's tensors are
    broadcast to every rank first, rank 0 alone writes the checkpoints
    (the ranks wait for it), and a resume loads the same checkpoint on
    every rank.
    """
    _check_mesh(mesh)
    if optimizer is None:
        optimizer = functools.partial(torch.optim.Adam, lr=1e-3)
    if mask is None:
        mask = trainable_mask(model)
    build = masked_optimizer(optimizer, mask)
    opt, start_step = None, 0

    if checkpoint_dir is not None and resume:
        latest = latest_checkpoint(checkpoint_dir)
        if latest is not None:
            model, opt, start_step = load_training_state(
                latest, build, device=_model_device(model))
    if opt is None:
        opt = build(model)
    if _collective(mesh):
        broadcast_tensors([t for _, t in named_tensors(model)], mesh)

    step = make_train_step(loss_fn, mesh)
    it = iter(data_iter)
    # the iterator is deterministic in its seed: skipping start_step
    # batches lands where the interrupted run stopped
    for _ in range(start_step):
        if next(it, None) is None:
            break

    losses = []
    i = start_step
    while num_steps is None or i < num_steps:
        batch = next(it, None)
        if batch is None:
            break
        model, opt, loss = step(model, opt, batch)
        losses.append(loss)
        i += 1
        if log_every and i % log_every == 0:
            print(f"step {i}: loss={float(loss):.6g}")
        if (checkpoint_dir is not None and checkpoint_every
                and i % checkpoint_every == 0):
            if mesh is None or mesh.rank == 0:
                save_training_state(checkpoint_dir, model, opt, i)
            if _collective(mesh):
                barrier(mesh)
    return TrainResult(model=model, losses=[float(v) for v in losses])
