"""Data parallelism on the card: the ranks of ``chip_smoke.py``'s phase 15.

    python -m molann_tpu_torch.probes.mesh_probe ref DIR
    python -m molann_tpu_torch.probes.mesh_probe two RANK PORT DIR

``ref`` forms a world of one over NCCL (``initialize_multihost()`` with no
arguments) and runs each case twice, without a mesh and on the world's
mesh, whose collectives run over one rank; ``two`` is rank RANK of two
ranks that share ``cuda:0`` over gloo on localhost:PORT (NCCL refuses two
ranks on one card; gloo takes CUDA tensors for ``all_reduce`` and
``broadcast``, the only collectives the port uses). The cases, on the
inputs ``chip_smoke.py`` writes into DIR (the sizes in ``sizes.json``):

- ``ala_fused``: ``make_fused_train_step(mesh, transposed_input=True)``,
  10 Adam steps of 65,536 alanine frames (K3);
- ``ala_fit``: ``fit(fused_mse_loss, mesh=)``, 10 steps (K1 and K2), a
  checkpoint every 5; with ``two`` also ``ala_resume``, the run resumed
  from the step-5 checkpoint;
- ``ala_serve`` / ``ala_values``: ``evaluate_trajectory(mesh=)`` of
  1,048,576 alanine frames with forces (K4) and without (K1), in batches
  of 65,536; ``two`` writes its rows into memmaps (forces by
  ``grads_transform=np.negative``);
- ``pep_fused`` and ``pep_fit``: the same two trainers on
  ``peptide_model(60)``, 5 steps of 65,536 frames (K5; K6 and K7);
- ``pep_serve``: ``evaluate_trajectory(mesh=, forces=True)`` of 131,072
  peptide frames (K8);
- ``ala_decay``: ``fit`` of ``fused_mse_loss`` plus a weight decay of
  ``1e-2 * sum(|p|^2)`` over the ``parameters()`` of the model the loss
  receives, 10 steps (K1 and K2);
- ``ala_penalty``: one step of that loss with ``SGD(lr=0)`` on the first
  batch, on the mesh and without it, the decay's own gradient beside, and
  a loss that reads the decay from the unwrapped model (past the
  ``ShardedModel``): ``two`` records the error it raises, ``ref`` that it
  ran.

The inputs: per system (``ala``, ``pep``) the model ``<sys>.npz``, the
frames ``<sys>.npy`` and the training targets ``<sys>_y.npy``. Each process
writes ``DIR/<mode>.rank<r>.npz`` (per trainer its losses, the parameters
before each step and at the end, and each step's host seconds, the
parameters' copy to the host included; ``ref`` writes the served arrays as
``ref_<case>_<cvs|grads>.npy``, ``two`` into
``two_<case>_<cvs|grads>.npy``) and ``DIR/<mode>.rank<r>.json`` (per case
the kernel launches, the seconds on the host clock after a synchronise,
and with ``ref`` whether the mesh run gave the plain run's bits).
"""

from __future__ import annotations

import functools
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch



def _params(model):
    from molann_tpu_torch.models.ann import named_tensors

    return torch.cat([t.detach().reshape(-1).double()
                      for _, t in named_tensors(model)]).cpu().numpy()


def _sizes(d):
    """The batch, the steps of each system and the checkpoint interval."""
    return json.loads((d / "sizes.json").read_text())


def _batches(d, name, transposed=False):
    """The global batches every rank draws from one seed."""
    from molann_tpu_torch.train import TrajectoryDataset, batch_iterator

    y = np.load(d / f"{name}_y.npy")
    for xb, idx in batch_iterator(TrajectoryDataset(str(d / f"{name}.npy")),
                                  _sizes(d)["batch"], seed=0,
                                  return_indices=True):
        yb = y[idx]
        if transposed:
            l = xb.shape[0]
            yield (np.ascontiguousarray(xb.reshape(l, -1).T),
                   np.ascontiguousarray(yb.T))
        else:
            yield xb, yb


class _Case:
    """One case's launches, host seconds and arrays."""

    def __init__(self, out, name):
        from molann_tpu_torch.ops import fused as F

        self.F, self.out, self.name = F, out, name

    def __enter__(self):
        for k in self.F.KERNEL_LAUNCHES:
            self.F.KERNEL_LAUNCHES[k] = 0
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            torch.cuda.synchronize()
            self.out["json"][self.name] = {
                "launches": {k: v for k, v in self.F.KERNEL_LAUNCHES.items()
                             if v},
                "seconds": time.perf_counter() - self.t0}
        return False


def _fused(d, mesh, name, transposed):
    from molann_tpu_torch.io import load_model
    from molann_tpu_torch.train import (make_fused_train_step,
                                        masked_optimizer, trainable_mask)

    dev = mesh.device if mesh is not None else torch.device("cuda", 0)
    model = load_model(str(d / f"{name}.npz"), device=dev)
    opt = masked_optimizer(functools.partial(torch.optim.Adam, lr=1e-3),
                           trainable_mask(model))(model)
    step = make_fused_train_step(mesh, transposed_input=transposed)
    steps = _sizes(d)[f"{name}_steps"]
    losses, params, ends = [], [_params(model)], [time.perf_counter()]
    for batch in _batches(d, name, transposed):
        if len(losses) == steps:
            break
        model, opt, loss = step(model, opt, batch)
        losses.append(loss.item())
        params.append(_params(model))
        ends.append(time.perf_counter())
    return {"losses": np.array(losses), "params": np.stack(params),
            "step_seconds": np.diff(ends)}


PENALTY = 1e-2


def _decay(model):
    """The weight decay over ``model.parameters()``."""
    return PENALTY * sum((p * p).sum() for p in model.parameters())


def _fit(d, mesh, name, ckpt=None, decay=False):
    from molann_tpu_torch.io import load_model
    from molann_tpu_torch.train import fit, fused_mse_loss

    dev = mesh.device if mesh is not None else torch.device("cuda", 0)
    model = load_model(str(d / f"{name}.npz"), device=dev)
    params, starts = [], []

    def loss_fn(m, batch):  # the parameters each step starts from
        params.append(_params(getattr(m, "module", m)))
        starts.append(time.perf_counter())
        return fused_mse_loss(m, batch) + (_decay(m) if decay else 0.0)

    sz = _sizes(d)
    res = fit(model, loss_fn, _batches(d, name), mesh=mesh,
              num_steps=sz[f"{name}_steps"],
              checkpoint_dir=None if ckpt is None else str(ckpt),
              checkpoint_every=sz["ckpt_every"] if ckpt else 0)
    params.append(_params(res.model))
    starts.append(time.perf_counter())
    return {"losses": np.array(res.losses), "params": np.stack(params),
            "step_seconds": np.diff(starts)}


def _penalty(d, mesh):
    """``(arrays, error)``: the gradients of one ``SGD(lr=0)`` step of
    ``fused_mse_loss`` plus the decay on the first alanine batch, on
    ``mesh`` (``ranks``) and without a mesh (``plain``), the decay's own
    gradient (``decay``), all flat on the host; and the error a loss that
    reads the decay from the unwrapped model raises on ``mesh`` ("" where
    it runs)."""
    from molann_tpu_torch.io import load_model
    from molann_tpu_torch.train import (fused_mse_loss, make_train_step,
                                        masked_optimizer, trainable_mask)

    batch = next(_batches(d, "ala"))

    def flat(tensors):
        return torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()

    def fresh():
        model = load_model(str(d / "ala.npz"), device=mesh.device)
        sgd = functools.partial(torch.optim.SGD, lr=0.0)
        return model, masked_optimizer(sgd, trainable_mask(model))(model)

    out = {}
    for tag, m in (("ranks", mesh), ("plain", None)):
        model, opt = fresh()
        make_train_step(lambda mm, b: fused_mse_loss(mm, b) + _decay(mm),
                        m)(model, opt, batch)
        out[tag] = flat(p.grad for p in model.parameters())
    out["decay"] = flat(torch.autograd.grad(_decay(model),
                                            list(model.parameters())))
    model, opt = fresh()
    try:
        make_train_step(lambda mm, b: _decay(model) + _decay(mm),
                        mesh)(model, opt, batch)
        error = ""
    except RuntimeError as e:
        error = str(e)
    return out, error


def _serve(d, mesh, name, forces, **kw):
    from molann_tpu_torch.io import load_model
    from molann_tpu_torch.serve import evaluate_trajectory

    dev = mesh.device if mesh is not None else torch.device("cuda", 0)
    model = load_model(str(d / f"{name}.npz"), device=dev)
    return evaluate_trajectory(model, str(d / f"{name}.npy"), mesh=mesh,
                               device=None if mesh is not None else dev,
                               forces=forces, batch_size=_sizes(d)["batch"],
                               **kw)


def _same(a, b):
    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple)
                                                   else (b,))
    return all(np.array_equal(x.view(np.uint8), y.view(np.uint8))
               for x, y in zip(a, b))


def run_ref(d):
    """The world of one over NCCL: every case without a mesh and on it."""
    import torch.distributed as dist

    from molann_tpu_torch.parallel import data_mesh, initialize_multihost

    initialize_multihost()
    try:
        mesh = data_mesh()
        assert mesh.group is not None and mesh.size == 1
        out = {"json": {"backend": dist.get_backend(), "world": 1,
                        "device": str(mesh.device)}, "npz": {}}
        trainers = (("ala_fused", lambda m: _fused(d, m, "ala", True)),
                    ("ala_fit", lambda m: _fit(d, m, "ala")),
                    ("pep_fused", lambda m: _fused(d, m, "pep", False)),
                    ("pep_fit", lambda m: _fit(d, m, "pep")),
                    ("ala_decay", lambda m: _fit(d, m, "ala", decay=True)))
        for name, run in trainers:
            plain = run(None)
            with _Case(out, name):
                got = run(mesh)
            out["json"][name]["same_bits_as_plain"] = all(
                _same(got[k], plain[k]) for k in ("losses", "params"))
            out["npz"].update({f"{name}:{k}": v for k, v in got.items()})
        with _Case(out, "ala_penalty"):
            got, error = _penalty(d, mesh)
        out["json"]["ala_penalty"]["bypass"] = error
        out["npz"].update({f"ala_penalty:{k}": v for k, v in got.items()})
        servers = (("ala_serve", "ala", True), ("ala_values", "ala", False),
                   ("pep_serve", "pep", True))
        for name, data, forces in servers:
            plain = _serve(d, None, data, forces)
            with _Case(out, name):
                got = _serve(d, mesh, data, forces)
            out["json"][name]["same_bits_as_plain"] = _same(got, plain)
            got = got if forces else (got,)
            for k, a in zip(("cvs", "grads"), got):
                np.save(d / f"ref_{name}_{k}.npy", a)
        return out
    finally:
        dist.destroy_process_group()


def run_two(d, rank, port):
    """Rank ``rank`` of two sharing ``cuda:0`` over gloo."""
    import torch.distributed as dist

    from molann_tpu_torch.parallel import data_mesh, initialize_multihost
    from molann_tpu_torch.parallel.data_parallel import barrier

    torch.cuda.set_device(0)
    initialize_multihost(f"localhost:{port}", 2, rank, backend="gloo")
    try:
        mesh = data_mesh()
        assert mesh.size == 2 and mesh.device == torch.device("cuda", 0)
        out = {"json": {"backend": dist.get_backend(), "world": 2,
                        "device": str(mesh.device)}, "npz": {}}
        ckpt, again = d / "ckpt", d / "resume"
        cases = (("ala_fused", lambda: _fused(d, mesh, "ala", True)),
                 ("ala_fit", lambda: _fit(d, mesh, "ala", ckpt)),
                 ("pep_fused", lambda: _fused(d, mesh, "pep", False)),
                 ("pep_fit", lambda: _fit(d, mesh, "pep")),
                 ("ala_decay", lambda: _fit(d, mesh, "ala", decay=True)))
        for name, run in cases:
            with _Case(out, name):
                got = run()
            out["npz"].update({f"{name}:{k}": v for k, v in got.items()})
            if name == "ala_fit":  # resume from step 5 on both ranks
                if rank == 0:
                    again.mkdir()
                    for suffix in (".model.npz", ".opt.npz"):
                        step = _sizes(d)["ckpt_every"]
                        shutil.copy(ckpt / f"ckpt_{step:010d}{suffix}", again)
                barrier(mesh)
                with _Case(out, "ala_resume"):
                    got = _fit(d, mesh, "ala", again)
                out["npz"].update({f"ala_resume:{k}": v
                                   for k, v in got.items()})
        with _Case(out, "ala_penalty"):
            got, error = _penalty(d, mesh)
        out["json"]["ala_penalty"]["bypass"] = error
        out["npz"].update({f"ala_penalty:{k}": v for k, v in got.items()})
        # served rows straight into memmaps of one file per output
        for name, data, forces, transform in (
                ("ala_serve", "ala", True, np.negative),
                ("ala_values", "ala", False, None),
                ("pep_serve", "pep", True, None)):
            ref = [np.load(d / f"ref_{name}_{k}.npy", mmap_mode="r")
                   for k in (("cvs", "grads") if forces else ("cvs",))]
            paths = [d / f"two_{name}_{k}.npy" for k in ("cvs", "grads")]
            if rank == 0:
                for p, r in zip(paths, ref):
                    np.lib.format.open_memmap(p, mode="w+", dtype=np.float32,
                                              shape=r.shape)
            barrier(mesh)
            outs = [np.load(p, mmap_mode="r+") for p in paths[:len(ref)]]
            with _Case(out, name):
                _serve(d, mesh, data, forces, cvs_out=outs[0],
                       grads_out=outs[1] if forces else None,
                       grads_transform=transform)
            for o in outs:
                o.flush()
            barrier(mesh)
        out["json"]["ckpts"] = sorted(p.name for p in ckpt.iterdir())
        return out
    finally:
        dist.destroy_process_group()


def main(argv):
    if argv[0] == "ref":
        d, rank = Path(argv[1]), 0
        out = run_ref(d)
    else:
        rank, port, d = int(argv[1]), argv[2], Path(argv[3])
        out = run_two(d, rank, port)
    np.savez(d / f"{argv[0]}.rank{rank}.npz", **out["npz"])
    (d / f"{argv[0]}.rank{rank}.json").write_text(json.dumps(out["json"]))


if __name__ == "__main__":
    main(sys.argv[1:])
