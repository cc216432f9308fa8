"""Trajectory serving on one device (port of ``molann_tpu/serve.py:99-177``).

Stream a trajectory through the fused serving ops in fixed-size batches,
producing CV values and (optionally) their coordinate gradients for
biased MD::

    from molann_tpu_torch.serve import evaluate_trajectory
    cvs, grads = evaluate_trajectory(model, "traj.npy", forces=True)

This runs on the card: ``device`` defaults to it, and where no CUDA device
is present the call raises; pass ``device="cpu"`` to run on the host.

Each batch is read on the host, padded with its last frame up to the batch
size (only the tail batch pays padding, the contract of the JAX package and
its C++ container), run on ``device`` by :func:`fused_cv_forces` or
:func:`fused_model_forward`, and trimmed back on the host. On a CUDA
device every batch is one kernel launch: the unrolled kernels for a small
system, the blocked ones for a peptide or a condensed-phase system
(``mode="auto"``). Several devices (``torch.distributed``) come later
(ROADMAP.md).
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

__all__ = ["evaluate_trajectory"]

_QUANTUM = 8
_MESH_TODO = ("mesh= (serving over several devices) is not ported to "
              "molann_tpu_torch yet (ROADMAP.md, queue 2, item 5)")


def evaluate_trajectory(model, traj, *, mesh=None, device=None, forces=False,
                        batch_size=None, mode="auto", tile=None,
                        interpret=False, precision="exact", component=None,
                        cvs_out=None, grads_out=None, grads_transform=None,
                        backend="auto", c_mat="auto"):
    """Evaluate every frame of ``traj``; returns ``cvs [n_frames, d]`` (and
    ``grads [n_frames, n, 3]`` with ``forces=True``) as numpy arrays.

    ``traj``: a ``[l, n, 3]`` array or a trajectory path.
    ``batch_size`` defaults to ``min(n_frames, 65536)`` rounded up to a
    multiple of 8. ``cvs_out`` / ``grads_out``: optional preallocated
    outputs (e.g. memmaps) shaped ``[n_frames, d]`` and ``[n_frames, n,
    3]``. ``grads_transform``: applied to each gradient block before it is
    stored (``np.negative`` gives forces). ``mode`` and ``precision`` go
    to the fused ops; ``tile`` and ``interpret`` are kept for the JAX
    signature, checked, and change nothing (the CUDA kernels choose their
    own tile; a CPU device runs the plain versions). ``c_mat``: ``"auto"`` (default)
    builds the pair operand of a blocked model with large coordination
    features once and hands the same device tensor to every batch; pass a
    tensor from :func:`~molann_tpu_torch.ops.fused.model_chunk_matrix`, or
    ``None`` to leave it to the ops' own cache. ``device``: ``None`` means
    the card (an error without one), ``"cpu"`` the host. The model is
    copied to ``device``; the caller's model is left where it is.
    ``backend``: the trajectory reader (``"auto"``, ``"native"`` or
    ``"numpy"``, see :func:`~molann_tpu_torch.io.reader.open_frame_reader`).
    ``traj`` may be any format that reader takes. ``mesh``: only
    ``None`` (one device); serving over several devices is not ported and
    any other value raises ``NotImplementedError``.
    """
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    check_tile_args(tile, interpret)
    device = resolve_device(device)
    read, n_frames, n_atoms = open_frame_reader(traj, backend=backend)
    try:
        if batch_size is None:
            batch_size = min(-(-n_frames // _QUANTUM) * _QUANTUM, 65536)
        batch_size = max(_QUANTUM, (batch_size // _QUANTUM) * _QUANTUM)
        model = copy.deepcopy(model).to(device)
        if isinstance(c_mat, str) and c_mat == "auto":
            c_mat = None
            if mode == "blocked" or (mode == "auto"
                                     and model_select_mode(model) == "blocked"):
                c_mat = model_chunk_matrix(model)
        if c_mat is not None:
            c_mat = torch.as_tensor(c_mat, device=device)
        kwargs = dict(mode=mode, tile=tile, precision=precision, c_mat=c_mat)

        if cvs_out is None:
            cvs_out = np.empty((n_frames, model_dims(model)[1]), np.float32)
        if forces and grads_out is None:
            grads_out = np.empty((n_frames, n_atoms, 3), np.float32)
        with torch.no_grad():
            for start in range(0, n_frames, batch_size):
                take = min(batch_size, n_frames - start)
                chunk = read(start, take)
                if take < batch_size:  # pad the tail with its last frame
                    pad = np.broadcast_to(chunk[-1:],
                                          (batch_size - take, n_atoms, 3))
                    chunk = np.concatenate([chunk, pad])
                x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
                if forces:
                    y, g = fused_cv_forces(model, x, component=component,
                                           **kwargs)
                    gb = g[:take].cpu().numpy()
                    if grads_transform is not None:
                        gb = grads_transform(gb)
                    grads_out[start:start + take] = gb
                else:
                    y = fused_model_forward(model, x, **kwargs)
                cvs_out[start:start + take] = y[:take].cpu().numpy()
    finally:
        read.close()
    return (cvs_out, grads_out) if forces else cvs_out
