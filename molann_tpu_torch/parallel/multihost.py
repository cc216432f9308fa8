"""Several processes, one device each: the port of
``molann_tpu/parallel/multihost.py``.

Every rank calls :func:`initialize_multihost` before its first collective;
it wraps ``torch.distributed.init_process_group`` with a TCP rendezvous
and an explicit timeout, so that a missing peer fails rather than hangs.
The arguments may come from JAX's variables (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) or from ``torchrun``'s
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)::

    torchrun --nproc-per-node 4 train.py   # in train.py:
    initialize_multihost()
    mesh = data_mesh()
    fit(model, loss_fn, batches, mesh=mesh)

With none of them, it forms a world of one on a free localhost port.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, _check_axis

__all__ = ["initialize_multihost", "global_batch", "process_local_slice"]

# seconds a rank waits for its peers at the rendezvous and in a collective
INIT_TIMEOUT_S = 300


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env_int(*names):
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, *, backend=None):
    """Join this process to the process group of ``num_processes`` ranks
    (call once per process, before the first collective).

    ``coordinator_address``: ``"host:port"`` of rank 0's rendezvous;
    ``process_id``: this rank. Each falls back to JAX's variable, then to
    torchrun's. ``backend``: ``"nccl"`` (the default where there is a
    card) or ``"gloo"`` (the host, or several ranks sharing one card: gloo
    takes CUDA tensors for ``all_reduce`` and ``broadcast``). Under NCCL
    the rank's card becomes the current device."""
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    world = num_processes or _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE") or 1
    rank = process_id if process_id is not None else _env_int(
        "JAX_PROCESS_ID", "RANK")
    if rank is None:
        if world > 1:
            raise ValueError(f"{world} processes but no process_id (pass it, "
                             "or set JAX_PROCESS_ID or RANK)")
        rank = 0
    if addr is None:
        if world > 1:
            raise ValueError("no coordinator address for several processes "
                             "(pass host:port, or set JAX_COORDINATOR_ADDRESS "
                             "or MASTER_ADDR/MASTER_PORT)")
        addr = f"localhost:{free_port()}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((rank if local is None else local)
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=int(world),
        rank=int(rank), timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))


def global_batch(local_batch, mesh, axis: str = DATA_AXIS):
    """This process's frames (``local_batch``: a tensor or array, or a
    tuple, list or dict of them, the rank's rows of the global batch) on
    the mesh's device: the rank's share of the global batch the others
    hold theirs of. Every process contributes the same number of rows (the
    data loader's ``multiple_of``). With one process this is
    :func:`~molann_tpu_torch.parallel.shard_batch`."""
    from .data_parallel import _tree_map

    _check_axis(axis)
    return _tree_map(lambda a: torch.as_tensor(a).to(mesh.device), local_batch)


def process_local_slice(n_total: int):
    """``(start, stop)`` of this process's contiguous share of ``n_total``
    frames; ``n_total`` must divide by the number of processes."""
    initialized = dist.is_available() and dist.is_initialized()
    pc = dist.get_world_size() if initialized else 1
    pi = dist.get_rank() if initialized else 0
    if n_total % pc:
        raise ValueError(
            f"global batch {n_total} does not divide over {pc} processes")
    per = n_total // pc
    return pi * per, (pi + 1) * per
