"""Trajectory serving over the devices of a data mesh (port of
``molann_tpu/serve.py``).

Stream a trajectory through the fused serving ops in fixed-size batches,
producing CV values and (optionally) their coordinate gradients for
biased MD::

    from molann_tpu_torch.serve import evaluate_trajectory
    cvs, grads = evaluate_trajectory(model, "traj.npy", forces=True)

This runs on the card: ``device`` defaults to it, and where no CUDA device
is present the call raises; pass ``device="cpu"`` to run on the host.

Each batch is read on the host, padded with its last frame up to the batch
size (only the tail batch pays padding, the contract of the JAX package and
its C++ container), run on the device by :func:`fused_cv_forces` or
:func:`fused_model_forward`, and trimmed back on the host. On a CUDA
device every batch is one kernel launch: the unrolled kernels for a small
system, the blocked ones for a peptide or a condensed-phase system
(``mode="auto"``).

With ``mesh=`` (a :func:`~molann_tpu_torch.parallel.data_mesh` of one rank
per device, over ``torch.distributed``), every rank takes its contiguous
rows of each batch: it reads only those, runs them on its device with no
collective (frames are independent), and either writes them into the
caller's outputs or gathers every rank's rows, so that each rank returns
the whole arrays as JAX's single controller does.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ._device import resolve_device
from .io.reader import open_frame_reader
from .models.ann import model_dims
from .ops.fused import (
    check_tile_args,
    fused_cv_forces,
    fused_model_forward,
    model_chunk_matrix,
    model_select_mode,
)
from .parallel import data_mesh
from .parallel.data_parallel import gather_rows
from .parallel.mesh import DataMesh, batch_sharding, check_mesh

__all__ = ["make_serving_fn", "evaluate_trajectory"]

_QUANTUM = 8


def _local_fn(forces, component, kwargs):
    """``fn(model, x_local)``: the fused op on frames already on the
    rank's device."""

    def fn(m, x):
        with torch.no_grad():
            if forces:
                return fused_cv_forces(m, x, component=component, **kwargs)
            return fused_model_forward(m, x, **kwargs)

    return fn


def make_serving_fn(model, mesh=None, *, forces=True, mode="auto",
                    tile=None, interpret=False, precision="exact",
                    component=None, c_mat=None):
    """``fn(model, x [l, n, 3]) -> cvs`` (or ``(cvs, grads)`` with
    ``forces=True``) for this rank's rows of ``x``.

    ``l`` must divide by the mesh size; every rank passes the same global
    ``x`` and gets its contiguous rows' outputs, with no collective (frames
    are independent): what JAX's sharded output holds on the local devices.
    :func:`evaluate_trajectory` handles padding, trimming and streaming.
    ``mesh=None`` is :func:`~molann_tpu_torch.parallel.data_mesh` (the card,
    one rank without a process group). ``model`` must lie on the mesh's
    device. On a CUDA device each call is one launch of K4 or K1 (K8 or K6
    for a blocked model); on the CPU the plain versions run. ``c_mat``: the
    pair operand of :func:`~molann_tpu_torch.ops.fused.model_chunk_matrix`,
    put on the rank's device once. ``tile`` and ``interpret`` are checked
    and change nothing."""
    del model  # the returned function takes the model, as JAX's does
    check_tile_args(tile, interpret)
    if mesh is None:
        mesh = data_mesh()
    if c_mat is not None:
        c_mat = torch.as_tensor(c_mat, device=mesh.device)
    local = _local_fn(forces, component, dict(
        mode=mode, tile=tile, precision=precision, c_mat=c_mat))

    shard = batch_sharding(mesh)

    def fn(m, x):
        return local(m, shard(x))

    return fn


def _resolve_mesh(mesh, device):
    if mesh is None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return DataMesh(None, 0, 1, dev)
    check_mesh(mesh)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device={device} is not the mesh's device "
                         f"{mesh.device}")
    return mesh


def evaluate_trajectory(model, traj, *, mesh=None, device=None, forces=False,
                        batch_size=None, mode="auto", tile=None,
                        interpret=False, precision="exact", component=None,
                        cvs_out=None, grads_out=None, grads_transform=None,
                        backend="auto", c_mat="auto"):
    """Evaluate every frame of ``traj``; returns ``cvs [n_frames, d]`` (and
    ``grads [n_frames, n, 3]`` with ``forces=True``) as numpy arrays.

    ``traj``: a ``[l, n, 3]`` array or a trajectory path.
    ``batch_size`` defaults to ``min(n_frames, 65536)`` rounded up to a
    multiple of ``8 × mesh size``. ``cvs_out`` / ``grads_out``: optional
    preallocated outputs (e.g. memmaps) shaped ``[n_frames, d]`` and
    ``[n_frames, n, 3]``. ``grads_transform``: applied to each gradient
    block before it is stored (``np.negative`` gives forces). ``mode`` and
    ``precision`` go to the fused ops; ``tile`` and ``interpret`` are kept
    for the JAX signature, checked, and change nothing (the CUDA kernels
    choose their own tile; a CPU device runs the plain versions). ``c_mat``:
    ``"auto"`` (default) builds the pair operand of a blocked model with
    large coordination features once and hands the same device tensor to
    every batch; pass a tensor from
    :func:`~molann_tpu_torch.ops.fused.model_chunk_matrix`, or ``None`` to
    leave it to the ops' own cache. ``device``: ``None`` means the card (an
    error without one), ``"cpu"`` the host. The model is copied to the
    device; the caller's model is left where it is. ``backend``: the
    trajectory reader (``"auto"``, ``"native"`` or ``"numpy"``, see
    :func:`~molann_tpu_torch.io.reader.open_frame_reader`). ``traj`` may be
    any format that reader takes.

    ``mesh``: a :func:`~molann_tpu_torch.parallel.data_mesh`; the device is
    the mesh's (``device``, if given, must agree). Every rank calls this
    with the same arguments and reads, runs and pads only its rows of each
    batch. Given ``cvs_out`` / ``grads_out``, each rank writes its rows
    straight into them (memmaps of one file make the whole); otherwise the
    rows are gathered and every rank returns the whole arrays."""
    check_tile_args(tile, interpret)
    mesh = _resolve_mesh(mesh, device)
    device = mesh.device
    read, n_frames, n_atoms = open_frame_reader(traj, backend=backend)
    try:
        quantum = _QUANTUM * mesh.size
        if batch_size is None:
            batch_size = min(-(-n_frames // quantum) * quantum, 65536)
        batch_size = max(quantum, (batch_size // quantum) * quantum)
        per = batch_size // mesh.size
        model = copy.deepcopy(model).to(device)
        if isinstance(c_mat, str) and c_mat == "auto":
            c_mat = None
            if mode == "blocked" or (mode == "auto"
                                     and model_select_mode(model) == "blocked"):
                c_mat = model_chunk_matrix(model)
        if c_mat is not None:
            c_mat = torch.as_tensor(c_mat, device=device)
        fn = _local_fn(forces, component, dict(
            mode=mode, tile=tile, precision=precision, c_mat=c_mat))

        gather_y, gather_g = cvs_out is None, forces and grads_out is None
        if cvs_out is None:
            cvs_out = np.empty((n_frames, model_dims(model)[1]), np.float32)
        if gather_g:
            grads_out = np.empty((n_frames, n_atoms, 3), np.float32)
        for start in range(0, n_frames, batch_size):
            take = min(batch_size, n_frames - start)
            lo = start + mesh.rank * per          # this rank's rows
            own = max(0, min(per, start + take - lo))
            # the tail is padded with the batch's last frame, which a rank
            # past the end reads alone
            chunk = read(lo, own) if own else read(start + take - 1, 1)
            if len(chunk) < per:
                pad = np.broadcast_to(chunk[-1:], (per - len(chunk),
                                                   n_atoms, 3))
                chunk = np.concatenate([chunk, pad])
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
            out = fn(model, x)
            y, g = out if forces else (out, None)
            if gather_y:
                cvs_out[start:start + take] = \
                    gather_rows(y, mesh)[:take].cpu().numpy()
            elif own:
                cvs_out[lo:lo + own] = y[:own].cpu().numpy()
            if g is None:
                continue
            if gather_g:
                gb, at, rows = gather_rows(g, mesh)[:take], start, take
            else:
                gb, at, rows = g[:own], lo, own
            if rows:
                gb = gb.cpu().numpy()
                if grads_transform is not None:
                    gb = grads_transform(gb)
                grads_out[at:at + rows] = gb
    finally:
        read.close()
    return (cvs_out, grads_out) if forces else cvs_out
