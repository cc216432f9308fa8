"""Trajectory serving on one device (port of ``molann_tpu/serve.py:99-177``).

Stream a trajectory through the fused serving ops in fixed-size batches,
producing CV values and (optionally) their coordinate gradients for
biased MD::

    from molann_tpu_torch.serve import evaluate_trajectory
    cvs, grads = evaluate_trajectory(model, "traj.npy", device="cuda",
                                     forces=True)

Each batch is read on the host, padded with its last frame up to the batch
size (only the tail batch pays padding, the contract of the JAX package and
its C++ container), run on ``device`` by :func:`fused_cv_forces` or
:func:`fused_model_forward`, and trimmed back on the host. On a CUDA
device every batch is one kernel launch. Several devices
(``torch.distributed``) come later (ROADMAP.md).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .io.reader import open_frame_reader
from .models.ann import model_dims
from .ops.fused import fused_cv_forces, fused_model_forward

__all__ = ["evaluate_trajectory"]

_QUANTUM = 8


def evaluate_trajectory(model, traj, *, device="cpu", forces=False,
                        batch_size=None, component=None, cvs_out=None,
                        grads_out=None, grads_transform=None):
    """Evaluate every frame of ``traj``; returns ``cvs [n_frames, d]`` (and
    ``grads [n_frames, n, 3]`` with ``forces=True``) as numpy arrays.

    ``traj``: a ``[l, n, 3]`` array or a ``.npy`` path (memory-mapped).
    ``batch_size`` defaults to ``min(n_frames, 65536)`` rounded up to a
    multiple of 8. ``cvs_out`` / ``grads_out``: optional preallocated
    outputs (e.g. memmaps) shaped ``[n_frames, d]`` and ``[n_frames, n,
    3]``. ``grads_transform``: applied to each gradient block before it is
    stored (``np.negative`` gives forces). The model is copied to
    ``device``; the caller's model is left where it is.
    """
    device = torch.device(device)
    read, n_frames, n_atoms = open_frame_reader(traj)
    if batch_size is None:
        batch_size = min(-(-n_frames // _QUANTUM) * _QUANTUM, 65536)
    batch_size = max(_QUANTUM, (batch_size // _QUANTUM) * _QUANTUM)
    model = copy.deepcopy(model).to(device)

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
                y, g = fused_cv_forces(model, x, component=component)
                gb = g[:take].cpu().numpy()
                if grads_transform is not None:
                    gb = grads_transform(gb)
                grads_out[start:start + take] = gb
            else:
                y = fused_model_forward(model, x)
            cvs_out[start:start + take] = y[:take].cpu().numpy()
    return (cvs_out, grads_out) if forces else cvs_out
