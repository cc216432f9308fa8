"""Data parallelism over frame batches: the port of
``molann_tpu/parallel/data_parallel.py``.

JAX's ``shard_map`` + ``psum``/``pmean`` become one process per rank and
``torch.distributed`` collectives. The collectives here use only
``all_reduce`` and ``broadcast``: NCCL refuses two ranks on one card, and
gloo takes CUDA tensors only for those two, so two ranks sharing one card
run over gloo with the same code as NCCL across cards. Every reduction is
one ``all_reduce`` of one flat buffer in a fixed order, with no float
atomics: every rank ends with the same bits.

A row gather is an ``all_reduce(SUM)`` over a ``[l_global, ...]`` buffer
filled with ``-0.0`` in which each rank writes its own rows: ``x + (-0.0)
== x`` for every float, signed zeros included, so the gather is exact.
:func:`gather_rows` and :func:`scatter_rows` are each other's adjoints
under autograd (a gather's backward takes this rank's rows, a scatter's
gathers them), to any order: the exact data-parallel form of the
batch-statistic losses (:func:`~molann_tpu_torch.train.loop.make_train_step`)
rests on them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, DataMesh, _check_axis, batch_sharding

__all__ = ["make_data_parallel_fn", "shard_batch", "psum_mean_grads"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_unflatten(v, it) for v in tree)
    return next(it)


def shard_batch(batch, mesh: DataMesh, axis: str = DATA_AXIS):
    """This rank's contiguous rows of each leaf of ``batch`` (a tensor or
    array, or a tuple, list or dict of them), on ``mesh.device``. The
    leading dimension must divide by the mesh size."""
    shard = batch_sharding(mesh, axis)
    return _tree_map(shard, batch)


def all_reduce_tensors(tensors, mesh: DataMesh, *, mean=False):
    """``tensors`` summed (or averaged, ``mean``) over the mesh by one
    ``all_reduce`` of one flat buffer, in their order; new tensors of the
    same shapes. A mesh without a group returns them as they are."""
    tensors = list(tensors)
    if mesh.group is None or not tensors:
        return tensors
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    if mean:
        flat = flat / mesh.size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def broadcast_tensors(tensors, mesh: DataMesh, src: int = 0):
    """Copy rank ``src``'s values of ``tensors`` into every rank's, in
    place, by one ``broadcast`` of one flat buffer."""
    tensors = list(tensors)
    if mesh.group is None or not tensors:
        return
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src=src, group=mesh.group)
        at = 0
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()


def barrier(mesh: DataMesh):
    """Wait for every rank of the mesh (nothing without a group)."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def _gather(t, mesh):
    n = t.shape[0] * mesh.size
    start, stop = mesh.rows(n)
    src = t.detach()
    wire = src.to(torch.uint8) if src.dtype == torch.bool else src
    fill = -0.0 if wire.is_floating_point() else 0
    buf = torch.full((n, *t.shape[1:]), fill, dtype=wire.dtype,
                     device=wire.device)
    buf[start:stop] = wire
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(torch.bool) if src.dtype == torch.bool else buf


class _GatherRows(torch.autograd.Function):
    """``[l_local, ...]`` -> ``[l_local * size, ...]`` in rank order; the
    adjoint takes this rank's rows of the incoming gradient, unsummed:
    every rank holds the identical upstream value."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _gather(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _ScatterRows.apply(grad, ctx.mesh), None


class _ScatterRows(torch.autograd.Function):
    """``[l_global, ...]`` -> this rank's rows; the adjoint gathers every
    rank's rows of the incoming gradient."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        start, stop = mesh.rows(t.shape[0])
        return t[start:stop]

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad.contiguous(), ctx.mesh), None


def gather_rows(t, mesh: DataMesh):
    """Every rank's rows of ``t`` (``[l_local, ...]``), concatenated in
    rank order, on every rank; exact, and differentiable (the gradient of
    this rank's rows is its rows of the gradient). A mesh without a group
    returns ``t``."""
    if mesh.group is None:
        return t
    return _GatherRows.apply(t, mesh)


def scatter_rows(t, mesh: DataMesh):
    """This rank's contiguous rows of ``t`` (``[l_global, ...]``),
    differentiable: the gradient of ``t`` is every rank's gradient of its
    rows, gathered."""
    if mesh.group is None:
        return t
    return _ScatterRows.apply(t, mesh)


def psum_mean_grads(grads, mesh: DataMesh):
    """Gradients (a dict of named tensors, or a sequence) averaged over the
    mesh: ``all_reduce(SUM)`` of one flat buffer, then ``/ size``. JAX
    names the mesh axis (``axis=``) inside ``shard_map``; here the mesh is
    passed."""
    if isinstance(grads, dict):
        names = list(grads)
        return dict(zip(names, all_reduce_tensors(
            [grads[k] for k in names], mesh, mean=True)))
    return type(grads)(all_reduce_tensors(grads, mesh, mean=True))


def make_data_parallel_fn(per_shard_fn, mesh: DataMesh, *,
                          axis: str = DATA_AXIS,
                          reduce_output: str | None = "mean"):
    """Wrap ``per_shard_fn(model, batch) -> value`` into a data-parallel
    function of the same ``(model, batch)``: each rank runs it on its rows
    of ``batch`` (every rank passes the global batch; the model, on
    ``mesh.device``, is replicated), then the output's tensors are
    all-reduced: ``reduce_output="mean"`` or ``"sum"``, or ``None`` for
    every rank's outputs concatenated in rank order along their first
    dimension, as ``out_specs=P(axis)`` stacks them."""
    _check_axis(axis)
    if reduce_output not in ("mean", "sum", None):
        raise ValueError(f"unknown reduce_output {reduce_output!r}")

    def fn(model, batch):
        value = per_shard_fn(model, shard_batch(batch, mesh))
        if reduce_output is None:
            return _tree_map(lambda v: gather_rows(v, mesh), value)
        leaves = [torch.as_tensor(v, device=mesh.device)
                  for v in _leaves(value)]
        reduced = all_reduce_tensors(leaves, mesh,
                                     mean=reduce_output == "mean")
        return _unflatten(value, iter(reduced))

    return fn


class ShardedModel:
    """A model (or one of its modules) whose calls run on this rank's rows
    and return every rank's rows: ``model(x)`` with ``x [l_global, ...]``
    is ``gather_rows(model(scatter_rows(x)))``. Attributes that are modules
    come back wrapped, so a loss that calls ``model.preprocessing_layer``
    and ``model.ann_layers`` apart shards each call; other attributes come
    back as they are. :meth:`map_rows` applies a function of the model to
    this rank's rows, as the fused ops do with a sharded model."""

    def __init__(self, module, mesh: DataMesh):
        self.module = module
        self.mesh = mesh

    def map_rows(self, fn, x, *args, **kwargs):
        y = fn(self.module, scatter_rows(x, self.mesh), *args, **kwargs)
        return _tree_map(lambda v: gather_rows(v, self.mesh), y)

    def __call__(self, x, *args, **kwargs):
        return self.map_rows(lambda m, xs, *a, **k: m(xs, *a, **k), x,
                             *args, **kwargs)

    def __getattr__(self, name):
        attr = getattr(self.module, name)
        if isinstance(attr, torch.nn.Module):
            return ShardedModel(attr, self.mesh)
        return attr


def sharded_model(model, mesh: DataMesh):
    """``model`` with every call sharded (:class:`ShardedModel`); a tuple
    of models (``(model, decoder)``) element by element."""
    if isinstance(model, (tuple, list)):
        return tuple(sharded_model(m, mesh) for m in model)
    return ShardedModel(model, mesh)
