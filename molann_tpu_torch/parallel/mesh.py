"""The data mesh: the port of ``molann_tpu/parallel/mesh.py``.

JAX runs one controller over every local device. The PyTorch idiom is one
process per device over ``torch.distributed``, as ``torchrun`` and DDP use,
so the port's mesh is a 1-D ``('data',)`` axis of ranks, one device each:
a :class:`DataMesh` names this rank's place on it and its device.
Parameters are replicated (they are KB-scale); frames are sharded, each
rank taking contiguous rows of the global batch, which every rank holds as
a JAX caller holds the global array.

With no process group, :func:`data_mesh` is a mesh of one on the device of
:func:`~molann_tpu_torch._device.resolve_device` and runs no collective,
so every ``mesh=`` entry point takes a plain call there. Start one rank per
device with :func:`~molann_tpu_torch.parallel.initialize_multihost` (or
``torchrun``), or let the CLI's ``--devices N`` start them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["data_mesh", "batch_sharding", "replicated_sharding"]

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataMesh:
    """This rank's place on a 1-D data mesh: the process group its
    collectives run over (None for a mesh of one without collectives),
    its index ``rank`` and the mesh's ``size``, and its ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self):
        """``{"data": size}``, as a JAX mesh's ``shape`` reads."""
        return {DATA_AXIS: self.size}

    def rows(self, n: int):
        """``(start, stop)``: this rank's contiguous share of ``n`` rows;
        ``n`` must divide by the mesh size."""
        if n % self.size:
            raise ValueError(
                f"a leading dimension of {n} does not divide over a mesh of "
                f"{self.size} (pad or crop the batch to a multiple of it)")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per


def check_mesh(mesh):
    """``mesh``, checked: None or a :class:`DataMesh`."""
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a molann_tpu_torch.parallel.data_mesh"
                        f"(), not {type(mesh).__name__}")
    return mesh


def _check_axis(axis):
    if axis != DATA_AXIS:
        raise ValueError(f"the port's mesh has one axis, {DATA_AXIS!r}, "
                         f"not {axis!r}")


def _rank_device(devices, rank, backend):
    """This rank's device: ``devices`` (a device, or a list indexed by
    rank) where given; else the card ``cuda:<LOCAL_RANK or rank % device
    count>``, or the host where the process group is gloo and there is no
    card."""
    if isinstance(devices, (list, tuple)):
        devices = devices[rank]
    if devices is not None:
        dev = resolve_device(devices)
    elif backend == "gloo" and not torch.cuda.is_available():
        dev = torch.device("cpu")
    else:
        dev = resolve_device(None)
        if backend is not None:
            local = os.environ.get("LOCAL_RANK")
            index = int(local) if local is not None else rank
            dev = torch.device("cuda", index % torch.cuda.device_count())
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def data_mesh(n_devices: int | None = None, devices=None) -> DataMesh:
    """A 1-D ``('data',)`` mesh over the ranks of the process group
    (default: all of them), with this rank's device.

    ``n_devices``: the world size, or 1 for a mesh of this rank alone (no
    collectives); more than the world raises ``ValueError``. ``devices``:
    this rank's device, or a list of devices indexed by rank; by default
    the card (see :func:`_rank_device`)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if n_devices is not None:
        if n_devices > world:
            hint = "" if initialized else (
                " (no process group: start one rank per device with "
                "molann_tpu_torch.parallel.initialize_multihost or "
                "torchrun, or pass the CLI's --devices N)")
            raise ValueError(f"requested {n_devices} devices, only {world} "
                             f"available{hint}")
        if n_devices not in (1, world):
            raise ValueError(
                f"a mesh spans one rank or all {world} ranks of the process "
                f"group, not {n_devices}")
    backend = dist.get_backend() if initialized else None
    rank = dist.get_rank() if initialized else 0
    device = _rank_device(devices, rank, backend)
    if n_devices == 1 or not initialized:
        return DataMesh(None, 0, 1, device)
    return DataMesh(dist.group.WORLD, rank, world, device)


def batch_sharding(mesh: DataMesh, axis: str = DATA_AXIS):
    """This rank's share of a frame batch: a function ``shard(a, dim=0)``
    from an array or tensor to its contiguous rows along ``dim`` (which
    must divide by the mesh size) on ``mesh.device``, where JAX returns a
    ``NamedSharding`` of the leading dimension."""
    _check_axis(axis)

    def shard(a, dim=0):
        t = torch.as_tensor(a)
        start, stop = mesh.rows(t.shape[dim])
        return t.narrow(dim, start, stop - start).to(
            mesh.device).contiguous()

    return shard


def replicated_sharding(mesh: DataMesh) -> torch.device:
    """Where replicated tensors (the parameters) live: the mesh's device,
    where JAX returns a replicated ``NamedSharding``."""
    return mesh.device
