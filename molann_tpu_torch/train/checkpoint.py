"""Training checkpoint and resume: the port of
``molann_tpu/train/checkpoint.py:29-113``.

The model goes through :func:`molann_tpu_torch.io.save_model` (the JAX
package's ``.npz`` format v1). The optimizer goes through
``optimizer.state_dict()``: its tensors as numpy arrays and the rest as
JSON in ``ckpt_<step>.opt.npz``. On resume the state is checked against a
freshly built optimizer, and any difference raises, so a changed optimizer
cannot silently restore the wrong state. A restored run repeats the
uninterrupted one bit for bit.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..io.serialize import load_model, save_model

__all__ = ["save_training_state", "load_training_state", "latest_checkpoint"]


def _groups_json(param_groups):
    return json.loads(json.dumps(param_groups, default=repr))


def save_training_state(directory, model, opt, step: int):
    """Write ``<directory>/ckpt_<step>.opt.npz`` and ``.model.npz``.

    Saves are atomic: both files are written to temporary names and
    renamed into place, the optimizer state first and the model file (the
    marker :func:`latest_checkpoint` keys on) last, so a crash mid-save
    never leaves a newest checkpoint that fails to load."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:010d}")
    sd = opt.state_dict()
    arrays, state = {}, {}
    for pid, entries in sd["state"].items():
        state[str(pid)] = {}
        for k, v in entries.items():
            if torch.is_tensor(v):
                key = f"opt_{len(arrays)}"
                arrays[key] = v.detach().cpu().numpy()
                state[str(pid)][k] = {"array": key}
            else:
                state[str(pid)][k] = {"value": v}
    meta = json.dumps({
        "step": int(step),
        "optimizer": type(opt).__name__,
        "param_groups": _groups_json(sd["param_groups"]),
        "state": state,
    })
    # np.savez appends .npz to a name without it
    np.savez(path + ".opt.npz.tmp",
             __meta__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays)
    save_model(path + ".model.npz.tmp.npz", model)
    os.replace(path + ".opt.npz.tmp.npz", path + ".opt.npz")
    os.replace(path + ".model.npz.tmp.npz", path + ".model.npz")
    return path


def latest_checkpoint(directory):
    """Path prefix of the newest COMPLETE checkpoint in ``directory``
    (both .model.npz and .opt.npz present), or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("ckpt_") and name.endswith(".model.npz"):
            steps.append(int(name[len("ckpt_"):-len(".model.npz")]))
    for step in sorted(steps, reverse=True):
        prefix = os.path.join(directory, f"ckpt_{step:010d}")
        if os.path.exists(prefix + ".opt.npz"):
            return prefix
    return None


def _mismatch(what):
    return ValueError(f"optimizer state mismatch: {what} — was the "
                      "optimizer configuration changed?")


def load_training_state(path_prefix, optimizer, *, device=None):
    """Restore ``(model, opt, step)`` from a checkpoint prefix, the model on
    ``device`` (the card when ``None``, an error without one; ``"cpu"`` for
    the host).

    ``optimizer`` is ``build(model) -> torch.optim.Optimizer``, as
    :func:`~molann_tpu_torch.train.loop.masked_optimizer` returns, and
    must build the optimizer used in training: the saved state is checked
    against a fresh one (its type, hyperparameters and tensor shapes)."""
    model = load_model(path_prefix + ".model.npz", device=device)
    with np.load(path_prefix + ".opt.npz") as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    opt = optimizer(model)
    template = opt.state_dict()
    if meta["optimizer"] != type(opt).__name__:
        raise _mismatch(f"checkpoint has {meta['optimizer']}, the optimizer "
                        f"is {type(opt).__name__}")
    if meta["param_groups"] != _groups_json(template["param_groups"]):
        raise _mismatch(f"checkpoint param_groups {meta['param_groups']} vs "
                        f"{_groups_json(template['param_groups'])}")
    tensors = [p for group in opt.param_groups for p in group["params"]]
    state = {}
    for pid, entries in meta["state"].items():
        pid = int(pid)
        if pid >= len(tensors):
            raise _mismatch(f"state for tensor {pid} of {len(tensors)}")
        state[pid] = {}
        for k, e in entries.items():
            if "value" in e:
                state[pid][k] = e["value"]
                continue
            a = arrays[e["array"]]
            if a.ndim and a.shape != tuple(tensors[pid].shape):
                raise _mismatch(f"state {k!r} of tensor {pid} has shape "
                                f"{a.shape}, the tensor "
                                f"{tuple(tensors[pid].shape)}")
            state[pid][k] = torch.from_numpy(a)
    opt.load_state_dict({"state": state,
                         "param_groups": template["param_groups"]})
    return model, opt, meta["step"]
