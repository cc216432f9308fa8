"""Ranks of the port's data-parallel tests: gloo processes on the CPU.

``python tests/torch_mesh_worker.py SUITE RANK WORLD PORT DIR`` joins a
process group of WORLD ranks on localhost:PORT, runs the suite's cases on
the inputs the test wrote into DIR, and writes each case's results to
``DIR/out/<case>.rank<RANK>.npz``. The test files start the ranks with
:class:`Ranks` (each under a timeout) and hold the results against the
JAX package in their own process. This module imports no JAX.
"""

import functools
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 240


class Ranks:
    """``world`` gloo ranks of ``suite`` over the inputs in ``d``, started
    at once; :meth:`wait` raises with their output where one fails or
    outlives ``timeout`` seconds, and kills what is left."""

    def __init__(self, suite, d, world=2, timeout=RANK_TIMEOUT_S):
        from molann_tpu_torch.parallel.multihost import free_port

        (Path(d) / "out").mkdir(exist_ok=True)
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
        port = str(free_port())
        self.suite, self.timeout = suite, timeout
        self.t0 = time.perf_counter()
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, suite, str(r), str(world), port,
             str(d)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env) for r in range(world)]

    def close(self):
        """Kill the ranks that are still running (a fixture's teardown)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    def wait(self):
        if hasattr(self, "seconds"):
            return self.seconds
        outs, failed = [], False
        try:
            for p in self.procs:
                left = max(1.0, self.timeout
                           - (time.perf_counter() - self.t0))
                outs.append(p.communicate(timeout=left)[0])
                failed |= p.returncode != 0
        except subprocess.TimeoutExpired:
            failed = True
            outs.append(f"timed out after {self.timeout} s")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            raise RuntimeError(f"the {self.suite} ranks failed:\n"
                               + "\n----\n".join(outs))
        self.seconds = time.perf_counter() - self.t0
        return self.seconds


def load(d, case, rank):
    with np.load(Path(d) / "out" / f"{case}.rank{rank}.npz") as z:
        return dict(z)


# ---------------------------------------------------------------- the ranks


def _save(d, mesh, case, **arrays):
    np.savez(Path(d) / "out" / f"{case}.rank{mesh.rank}.npz", **arrays)


def _tensors(model):
    """A model's tensors (``t:<name>``) and the gradients they hold after
    the last step (``g:<name>``)."""
    from molann_tpu_torch.models.ann import named_tensors

    out = {}
    for k, t in named_tensors(model):
        out[f"t:{k}"] = t.detach().numpy().copy()
        if t.grad is not None:
            out[f"g:{k}"] = t.grad.numpy().copy()
    return out


def _adam():
    import torch

    return functools.partial(torch.optim.Adam, lr=1e-2)


def suite_parallel(mesh, d):
    import torch

    from molann_tpu_torch.io import load_model
    from molann_tpu_torch.parallel import (data_mesh, global_batch,
                                           make_data_parallel_fn,
                                           process_local_slice,
                                           psum_mean_grads, shard_batch)
    from molann_tpu_torch.parallel.data_parallel import gather_rows
    from molann_tpu_torch.train import mse_loss

    x, y = np.load(d / "x.npy"), np.load(d / "y.npy")
    model = load_model(str(d / "model.npz"), device="cpu")
    xs, ys = shard_batch((x, y), mesh)
    lo, hi = process_local_slice(len(x))
    errors = []
    for bad in (lambda: process_local_slice(len(x) - 1),
                lambda: data_mesh(mesh.size + 1),
                lambda: shard_batch(x[:-1], mesh)):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    local = global_batch((x[lo:hi], y[lo:hi]), mesh)

    def grad_fn(m, batch):
        loss = mse_loss(m, batch)
        names = [k for k, p in m.named_parameters()]
        gs = torch.autograd.grad(loss, list(m.parameters()))
        return dict(zip(names, gs))

    with torch.no_grad():
        mean = make_data_parallel_fn(mse_loss, mesh)(model, (x, y))
        total = make_data_parallel_fn(mse_loss, mesh,
                                      reduce_output="sum")(model, (x, y))
        stacked = make_data_parallel_fn(lambda m, b: m(b[0]), mesh,
                                        reduce_output=None)(model, (x, y))
    grads = make_data_parallel_fn(grad_fn, mesh)(model, (x, y))
    by_hand = psum_mean_grads(grad_fn(model, (xs, ys)), mesh)
    zeros = gather_rows(torch.tensor([[-0.0, 0.0, float("inf")]]), mesh)
    _save(d, mesh, "parallel", xs=xs.numpy(), ys=ys.numpy(),
          lohi=np.array([lo, hi]), local_x=local[0].numpy(),
          local_y=local[1].numpy(), mean=mean.numpy(), total=total.numpy(),
          stacked=stacked.numpy(), zeros=zeros.numpy(),
          errors=np.array(errors),
          **{f"g:{k}": v.numpy() for k, v in grads.items()},
          **{f"h:{k}": v.numpy() for k, v in by_hand.items()})


def _loss_cases():
    from molann_tpu_torch.train import (autoencoder_loss,
                                        timelagged_autoencoder_loss)
    from molann_tpu_torch.train.losses import registry

    def ae(pair, x):
        m, dec = pair
        return autoencoder_loss(m.ann_layers, dec, m.preprocessing_layer, x)

    def tae(pair, batch):
        m, dec = pair
        return timelagged_autoencoder_loss(m.ann_layers, dec,
                                           m.preprocessing_layer, *batch)

    def penalty(params):
        return PENALTY * sum((p * p).sum() for p in params)

    def mse_decay(m, batch):
        return registry["mse"](m, batch) + penalty(m.parameters())

    def mse_first_weight(m, batch):
        return (registry["mse"](m, batch)
                + penalty([m.ann_layers.layers[0].weight]))

    def ae_decoder_decay(pair, x):
        return ae(pair, x) + penalty(p for _, p in pair[1].named_parameters())

    return {"mse": (registry["mse"], "model", ("x", "y")),
            "eigenfunction": (registry["eigenfunction"], "model",
                              ("x", "w")),
            "committor": (registry["committor"], "model", ("x", "labels")),
            "vamp": (registry["vamp"], "model", ("x_t", "x_tau", "w_t")),
            "autoencoder": (ae, "pair", "x"),
            "tae": (tae, "pair", ("x_t", "x_tau")),
            "mse_decay": (mse_decay, "model", ("x", "y")),
            "mse_first_weight": (mse_first_weight, "model", ("x", "y")),
            "autoencoder_decoder_decay": (ae_decoder_decay, "pair", "x")}


def _inputs(d, names):
    if isinstance(names, str):
        return np.load(d / f"{names}.npy")
    return tuple(np.load(d / f"{n}.npy") for n in names)


STEPS = 2
# the weight of the penalty terms that read parameters outside a model call
PENALTY = 1e-2


def suite_train(mesh, d):
    import torch

    from molann_tpu_torch.io import load_model
    from molann_tpu_torch.train import (fit, make_ensemble_train_step,
                                        make_fused_train_step,
                                        make_train_step, masked_optimizer,
                                        mse_loss, stack_models,
                                        trainable_mask)

    # one step's gradient of mse + the penalty over model.parameters() on
    # the ranks and without a mesh, and the penalty's own gradient: the
    # share of it the ranks' all-reduced gradient holds
    mse_decay = _loss_cases()["mse_decay"][0]
    x, y = np.load(d / "x.npy"), np.load(d / "y.npy")
    share = {}
    for tag, m in (("ranks", mesh), ("plain", None)):
        model = load_model(str(d / "model.npz"), device="cpu")
        opt = masked_optimizer(functools.partial(torch.optim.SGD, lr=0.0),
                               trainable_mask(model))(model)
        make_train_step(mse_decay, m)(model, opt, (x, y))
        share[tag] = np.concatenate([p.grad.numpy().ravel()
                                     for p in model.parameters()])
    share["penalty"] = np.concatenate([g.numpy().ravel() for g in (
        torch.autograd.grad(PENALTY * sum((p * p).sum()
                                          for p in model.parameters()),
                            list(model.parameters())))])
    _save(d, mesh, "penalty_share", **share)

    for name, (loss_fn, which, names) in _loss_cases().items():
        model = load_model(str(d / f"{which}.npz"), device="cpu")
        opt = masked_optimizer(_adam(), trainable_mask(model))(model)
        step = make_train_step(loss_fn, mesh)
        batch = _inputs(d, names)
        losses = []
        for _ in range(STEPS):
            model, opt, loss = step(model, opt, batch)
            losses.append(loss.item())
        out = {}
        for i, m in enumerate(model if which == "pair" else (model,)):
            out.update({f"{i}{k}": v for k, v in _tensors(m).items()})
        _save(d, mesh, f"step_{name}", losses=np.array(losses), **out)

    x, y = np.load(d / "x.npy"), np.load(d / "y.npy")
    l, n = x.shape[:2]
    for layout in ("lna", "t"):
        for mode in ("auto", "blocked"):
            model = load_model(str(d / "model.npz"), device="cpu")
            opt = masked_optimizer(_adam(), trainable_mask(model))(model)
            step = make_fused_train_step(mesh, transposed_input=layout == "t",
                                         mode=mode)
            batch = ((x, y) if layout == "lna"
                     else (x.reshape(l, 3 * n).T.copy(), y.T.copy()))
            losses = []
            for _ in range(STEPS):
                model, opt, loss = step(model, opt, batch)
                losses.append(loss.item())
            _save(d, mesh, f"fused_{layout}_{mode}", losses=np.array(losses),
                  **_tensors(model))

    members = stack_models([load_model(str(d / f"member{i}.npz"),
                                       device="cpu") for i in range(2)])
    for mode in ("shared", "member", "bagging"):
        ms = [load_model(str(d / f"member{i}.npz"), device="cpu")
              for i in range(2)]
        opts = [masked_optimizer(_adam(), trainable_mask(m))(m) for m in ms]
        step = make_ensemble_train_step(mse_loss, mesh, batch_mode=mode)
        batch = (np.stack([x, x[::-1]]), np.stack([y, y[::-1]])) \
            if mode == "member" else (x, y)
        gen = torch.Generator().manual_seed(5)
        losses = []
        for _ in range(STEPS):
            ms, opts, loss = step(ms, opts, batch, gen)
            losses.append(loss.numpy())
        _save(d, mesh, f"ensemble_{mode}", losses=np.array(losses),
              **{f"{i}{k}": v for i, m in enumerate(ms)
                 for k, v in _tensors(m).items()})
    del members

    # fit with checkpoints, then a resume from step 2
    batches = [(x[s:s + 32], y[s:s + 32]) for s in (0, 32, 16)] * 2
    ckpt, again = d / "ckpt", d / "resume"
    full = fit(load_model(str(d / "model.npz"), device="cpu"), mse_loss,
               iter(batches), optimizer=_adam(), mesh=mesh, num_steps=4,
               checkpoint_dir=str(ckpt), checkpoint_every=2)
    if mesh.rank == 0:
        again.mkdir()
        for suffix in (".model.npz", ".opt.npz"):
            shutil.copy(ckpt / f"ckpt_{2:010d}{suffix}", again)
    from molann_tpu_torch.parallel.data_parallel import barrier

    barrier(mesh)
    resumed = fit(load_model(str(d / "model.npz"), device="cpu"), mse_loss,
                  iter(batches), optimizer=_adam(), mesh=mesh, num_steps=4,
                  checkpoint_dir=str(again))
    _save(d, mesh, "fit", losses=np.array(full.losses),
          resumed=np.array(resumed.losses), **_tensors(full.model),
          **{f"r{k}": v for k, v in _tensors(resumed.model).items()},
          ckpts=np.array(sorted(p.name for p in ckpt.iterdir())))

    # a loss that closes over the model it trains, past the wrapper: it
    # raises under the collective step and fit, and a world of one runs it
    from molann_tpu_torch.parallel import data_mesh

    def bypassing(model):
        def loss(m, batch):
            w = model.ann_layers.layers[0].weight
            return mse_loss(m, batch) + PENALTY * (w * w).sum()
        return loss

    errors = {}
    for how in ("step", "fit"):
        model = load_model(str(d / "model.npz"), device="cpu")
        try:
            if how == "step":
                opt = masked_optimizer(_adam(), trainable_mask(model))(model)
                make_train_step(bypassing(model), mesh)(model, opt, (x, y))
            else:
                fit(model, bypassing(model), iter([(x, y)]), mesh=mesh,
                    num_steps=1)
            errors[how] = ""
        except RuntimeError as e:
            errors[how] = str(e)
    out = {f"error_{k}": np.array(v) for k, v in errors.items()}
    for tag, m in (("none", None), ("one", data_mesh(1, devices="cpu"))):
        model = load_model(str(d / "model.npz"), device="cpu")
        opt = masked_optimizer(_adam(), trainable_mask(model))(model)
        step = make_train_step(bypassing(model), m)
        losses = []
        for _ in range(STEPS):
            model, opt, loss = step(model, opt, (x, y))
            losses.append(loss.item())
        out[f"{tag}:losses"] = np.array(losses)
        out.update({f"{tag}:{k}": v for k, v in _tensors(model).items()})
    _save(d, mesh, "bypass", **out)


def suite_serve(mesh, d):
    import torch

    from molann_tpu_torch.io import load_model
    from molann_tpu_torch.ops.fused import model_chunk_matrix
    from molann_tpu_torch.serve import evaluate_trajectory, make_serving_fn

    for name in ("alanine", "fluid"):
        model = load_model(str(d / f"{name}.npz"), device="cpu")
        path = str(d / f"{name}_traj.npy")
        x = np.load(path)
        c_mat = model_chunk_matrix(model) if name == "fluid" else None
        fn = make_serving_fn(model, mesh, forces=True, c_mat=c_mat)
        y_fn, g_fn = fn(model, x[:32])
        y_only = make_serving_fn(model, mesh, forces=False,
                                 c_mat=c_mat)(model, torch.as_tensor(x[:32]))
        # gathered: every rank returns the whole arrays; the tail pads
        cvs, grads = evaluate_trajectory(model, path, mesh=mesh,
                                         forces=True, batch_size=32)
        cvs_only = evaluate_trajectory(model, x, mesh=mesh, batch_size=32,
                                       backend="numpy")
        # each rank's rows straight into shared memmaps, as forces
        y_path, g_path = d / f"{name}_y.npy", d / f"{name}_g.npy"
        if mesh.rank == 0:
            np.lib.format.open_memmap(y_path, mode="w+", dtype=np.float32,
                                      shape=cvs.shape)
            np.lib.format.open_memmap(g_path, mode="w+", dtype=np.float32,
                                      shape=grads.shape)
        from molann_tpu_torch.parallel.data_parallel import barrier

        barrier(mesh)
        y_mm = np.load(y_path, mmap_mode="r+")
        g_mm = np.load(g_path, mmap_mode="r+")
        evaluate_trajectory(model, path, mesh=mesh, forces=True,
                            batch_size=48, cvs_out=y_mm, grads_out=g_mm,
                            grads_transform=np.negative,
                            c_mat=c_mat if c_mat is None else
                            torch.as_tensor(c_mat))
        y_mm.flush()
        g_mm.flush()
        barrier(mesh)
        _save(d, mesh, f"serve_{name}", y_fn=y_fn.numpy(),
              g_fn=g_fn.numpy(), y_only=y_only.numpy(), cvs=cvs,
              grads=grads, cvs_only=cvs_only, y_mm=np.load(y_path),
              g_mm=np.load(g_path))


def suite_one(mesh, d):
    """A process group of one rank: the collectives run, and every
    ``mesh=`` entry point gives the bits of its call without a mesh."""
    from molann_tpu_torch.io import load_model
    from molann_tpu_torch.serve import evaluate_trajectory
    from molann_tpu_torch.train import (fit, fused_mse_loss,
                                        make_fused_train_step,
                                        make_train_step, masked_optimizer,
                                        trainable_mask)
    from molann_tpu_torch.train.losses import registry

    assert mesh.group is not None and mesh.size == 1
    x, y, w = (np.load(d / f"{k}.npy") for k in ("x", "y", "w"))
    out = {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        model = load_model(str(d / "model.npz"), device="cpu")
        opt = masked_optimizer(_adam(), trainable_mask(model))(model)
        step = make_train_step(registry["eigenfunction"], m)
        fused = make_fused_train_step(m)
        for _ in range(STEPS):
            model, opt, loss = step(model, opt, (x, w))
            model, opt, loss2 = fused(model, opt, (x, y))
        out.update({f"{tag}:{k}": v for k, v in _tensors(model).items()})
        out[f"{tag}:losses"] = np.array([loss.item(), loss2.item()])
        res = fit(load_model(str(d / "model.npz"), device="cpu"),
                  fused_mse_loss, iter([(x, y)] * 3), mesh=m)
        out[f"{tag}:fit"] = np.array(res.losses)
        cvs, grads = evaluate_trajectory(model, x, mesh=m, device="cpu",
                                         forces=True, batch_size=24)
        out[f"{tag}:cvs"], out[f"{tag}:grads"] = cvs, grads
    _save(d, mesh, "one", **out)


SUITES = {"parallel": suite_parallel, "train": suite_train,
          "serve": suite_serve, "one": suite_one}


def main():
    suite, rank, world, port, d = sys.argv[1:]
    import torch.distributed as dist

    from molann_tpu_torch.parallel import data_mesh, initialize_multihost

    initialize_multihost(f"localhost:{port}", int(world), int(rank),
                         backend="gloo")
    try:
        SUITES[suite](data_mesh(devices="cpu"), Path(d))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
