"""The ``train`` command: the port of ``molann_tpu/cli/train.py``.

Trains a saved model on a trajectory with any of the JAX command's
objectives, on the CUDA card by default (``--device cpu`` for the host),
and prints the same diagnostics. Its flags, messages and exit codes are
the JAX command's; ``--device`` is the port's own. ``--devices N`` trains
data parallel on N ranks, one device each (the cards; host processes with
``--device cpu``): batches are a multiple of N, each rank takes its rows of
every batch (``fit(mesh=)``, ``fit_ensemble(mesh=)``), and rank 0 writes
the outputs and prints.
"""

from __future__ import annotations

import functools
import sys

import numpy as np

from ._common import _device, _load_model, add_device_arg, run_ranks


def _make_optimizer(args):
    """The optimizer from the flags, as a callable from tensors to a
    ``torch.optim.Optimizer``: the update rule, the learning-rate schedule
    and the global-norm clip of optax, to optax's formulas
    (:mod:`molann_tpu_torch.train.optim`)."""
    from ..train import optim

    lr = args.lr
    if args.lr_schedule == "constant":
        sched = None
    elif args.lr_schedule == "cosine":
        sched = optim.cosine_decay_schedule(
            lr, max(1, args.steps), alpha=args.final_lr_scale)
    elif args.lr_schedule == "warmup-cosine":
        sched = optim.warmup_cosine_decay_schedule(
            0.0, lr, min(args.warmup_steps, args.steps),
            max(1, args.steps), end_value=lr * args.final_lr_scale)
    else:  # exponential: reach lr*final_lr_scale at the last step
        sched = optim.exponential_decay(
            lr, max(1, args.steps), max(args.final_lr_scale, 1e-8))
    rules = {
        "adam": (optim.Adam, {}),
        "adamw": (optim.AdamW, {"weight_decay": args.weight_decay}),
        "sgd": (optim.SGD, {"momentum": args.momentum}),
        "rmsprop": (optim.RMSprop, {}),
    }
    cls, kwargs = rules[args.optimizer]
    return functools.partial(cls, lr=lr, schedule=sched,
                             max_norm=args.grad_clip, **kwargs)


def _sample(n):
    """An evenly spaced sample of at most 4096 of ``n`` indices."""
    return np.unique(np.linspace(0, n - 1, min(n, 4096)).astype(int))


def cmd_train(args):
    """Train a saved model on a trajectory: MSE regression onto per-frame
    targets, the generator-eigenfunction loss, the committor loss, the
    VAMP-2 loss over lagged pairs, or the autoencoder / time-lagged
    autoencoder losses (the saved model's MLP is the encoder; a fresh
    decoder is trained with it and saved with ``--decoder-out``). The
    weighted objectives take per-frame importance weights."""
    return run_ranks(args, _train)


def _train(args, mesh):
    import torch

    from ..io import save_model
    from ..train import (
        TrajectoryDataset,
        batch_iterator,
        fit,
        make_eigenfunction_loss,
        mse_loss,
    )

    device = _device(args) if mesh is None else mesh.device
    multiple = 1 if mesh is None else mesh.size
    lead = mesh is None or mesh.rank == 0  # writes the outputs
    if args.bagging and not args.ensemble:
        print("error: --bagging requires --ensemble K", file=sys.stderr)
        return 1
    model = _load_model(args.model, device)
    ds = TrajectoryDataset(args.traj)
    n = len(ds)

    def dev(a):
        return torch.as_tensor(a, device=device)

    targets = weights = labels = None
    if args.loss != "mse" and args.weights:
        weights = np.asarray(np.load(args.weights), np.float32)
        if weights.shape != (n,):
            print(f"error: weights shape {weights.shape} != ({n},)",
                  file=sys.stderr)
            return 1
    # per-loss default penalty weight: orthonormality (eigenfunction)
    # converges around 10, boundary conditions (committor) need ~100
    alpha = args.alpha if args.alpha is not None else (
        100.0 if args.loss == "committor" else 10.0)
    if args.loss == "mse":
        if not args.targets:
            print("error: --loss mse requires --targets", file=sys.stderr)
            return 1
        targets = np.load(args.targets, mmap_mode="r")
        if len(targets) != n:
            print(f"error: targets rows {len(targets)} != frames {n}",
                  file=sys.stderr)
            return 1
        loss_fn = mse_loss
    elif args.loss == "eigenfunction":
        loss_fn = make_eigenfunction_loss(beta=args.beta, alpha=alpha)
    elif args.loss == "committor":
        from ..train import make_committor_loss

        if not args.labels:
            print("error: --loss committor requires --labels "
                  "(per-frame basin labels: 1=A, 2=B, 0=neither)",
                  file=sys.stderr)
            return 1
        labels = np.asarray(np.load(args.labels)).astype(np.int32)
        if labels.shape != (n,):
            print(f"error: labels shape {labels.shape} != ({n},)",
                  file=sys.stderr)
            return 1
        if not ((labels == 1).any() and (labels == 2).any()):
            print("error: labels must mark at least one frame in each "
                  "basin (1=A, 2=B)", file=sys.stderr)
            return 1
        loss_fn = make_committor_loss(beta=args.beta, alpha=alpha)
    elif args.loss == "vamp":
        from ..train import make_vamp_loss

        if args.lag < 1 or args.lag >= n:
            print(f"error: --lag must be in [1, {n}) for this trajectory",
                  file=sys.stderr)
            return 1
        loss_fn = make_vamp_loss()
    else:  # autoencoder / tae: the saved MolANN's MLP is the encoder; a
        # fresh decoder reconstructs the feature vector (tae: the feature
        # vector a lag LATER) and is discarded (or saved via
        # --decoder-out) after training
        from ..models.ann import MolANN, create_sequential_nn
        from ..train import autoencoder_loss, timelagged_autoencoder_loss

        if not isinstance(model, MolANN):
            print(f"error: --loss {args.loss} needs a MolANN model "
                  "(build with --mlp: the MLP is the encoder)",
                  file=sys.stderr)
            return 1
        if args.loss == "tae" and not 1 <= args.lag < n:
            print(f"error: --lag must be in [1, {n}) for this trajectory",
                  file=sys.stderr)
            return 1
        k = model.ann_layers.output_dimension()
        fdim = model.preprocessing_layer.output_dimension()
        dec_dims = [k, *(args.decoder_hidden or []), fdim]
        decoder = create_sequential_nn(
            dec_dims, generator=torch.Generator().manual_seed(args.seed + 1),
            device=device)

        if args.loss == "tae":

            def loss_fn(pair, batch):
                m, dec = pair
                x_t, x_tau, w = (batch if len(batch) == 3
                                 else (*batch, None))
                return timelagged_autoencoder_loss(
                    m.ann_layers, dec, m.preprocessing_layer, x_t, x_tau,
                    weights=w)
        else:

            def loss_fn(pair, batch):
                m, dec = pair
                if isinstance(batch, (tuple, list)):
                    x, w = batch
                else:
                    x, w = batch, None
                return autoencoder_loss(
                    m.ann_layers, dec, m.preprocessing_layer, x, weights=w)

        model = (model, decoder)

    def batches():
        if args.loss in ("vamp", "tae"):
            from ..train import lagged_pair_iterator

            for pair in lagged_pair_iterator(
                    ds, args.batch_size, args.lag, seed=args.seed,
                    multiple_of=multiple, weights=weights):
                yield tuple(dev(a) for a in pair)
            return
        it = batch_iterator(ds, args.batch_size, seed=args.seed,
                            multiple_of=multiple, return_indices=True)
        for x, idx in it:
            x = dev(x)
            if targets is not None:
                yield (x, dev(np.asarray(targets[idx], np.float32)))
            elif labels is not None:
                if weights is not None:
                    yield (x, dev(labels[idx]), dev(weights[idx]))
                else:
                    yield (x, dev(labels[idx]))
            elif weights is not None:
                yield (x, dev(weights[idx]))
            else:
                yield x

    if args.ensemble:
        # committee training: K freshly initialised members, trained one
        # after another on each batch (train/ensemble.py); members are
        # written as out-stem.member{i}.npz for the `committee` command
        from pathlib import Path

        from ..train import fit_ensemble, reinitialized_members

        if args.ensemble < 2:
            print("error: --ensemble needs at least 2 members",
                  file=sys.stderr)
            return 1
        if args.checkpoint_dir:
            print("error: --checkpoint-dir is not supported with "
                  "--ensemble", file=sys.stderr)
            return 1
        if args.decoder_out:
            print("error: --decoder-out is not supported with --ensemble "
                  "(per-member decoders are discarded)", file=sys.stderr)
            return 1
        try:
            members = reinitialized_members(model, args.ensemble,
                                            seed=args.seed)
        except TypeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        res = fit_ensemble(
            members, loss_fn, batches(), optimizer=_make_optimizer(args),
            mesh=mesh, num_steps=args.steps, log_every=args.log_every,
            bagging=args.bagging, seed=args.seed)
        if not lead:
            return 0
        out = Path(args.out)
        for i, m in enumerate(res.models):
            if args.loss in ("autoencoder", "tae"):
                m = m[0]
            save_model(str(out.with_name(f"{out.stem}.member{i}"
                                         f"{out.suffix}")), m)
        first = float(np.mean(res.losses[0]))
        last = float(np.mean(res.losses[-1]))
        print(f"trained committee of {args.ensemble} for "
              f"{len(res.losses)} steps: committee-mean loss "
              f"{first:.6g} -> {last:.6g}; wrote "
              f"{out.with_name(out.stem)}.member0..{args.ensemble - 1}"
              f"{out.suffix}")
        return 0

    res = fit(model, loss_fn, batches(), optimizer=_make_optimizer(args),
              mesh=mesh, num_steps=args.steps, log_every=args.log_every,
              checkpoint_dir=args.checkpoint_dir,
              checkpoint_every=args.checkpoint_every)
    if not lead:
        return 0
    trained = res.model
    if args.loss in ("autoencoder", "tae"):
        trained, decoder = trained
        if args.decoder_out:
            save_model(args.decoder_out, decoder)
    save_model(args.out, trained)
    print(f"trained {len(res.losses)} steps: loss {res.losses[0]:.6g} -> "
          f"{res.losses[-1]:.6g}; wrote {args.out}")
    if args.loss == "eigenfunction":
        # the learned spectrum on an evenly spaced frame sample
        from ..train import eigenfunction_loss

        sel = _sample(n)
        ws = dev(weights[sel]) if weights is not None else None
        with torch.no_grad():
            _, aux = eigenfunction_loss(
                trained, dev(ds[sel]), beta=args.beta, alpha=alpha,
                weights=ws, return_aux=True)
        eigs = aux["eigenvalues"].cpu().numpy()
        print("estimated generator eigenvalues (ascending = slowest "
              "first): " + ", ".join(f"{e:.4g}" for e in eigs))
    elif args.loss == "committor":
        # how well the boundary conditions are honoured
        from ..train import committor_loss

        sel = _sample(n)
        ws = dev(weights[sel]) if weights is not None else None
        with torch.no_grad():
            _, aux = committor_loss(
                trained, dev(ds[sel]), dev(labels[sel]), beta=args.beta,
                alpha=alpha, weights=ws, return_aux=True)
        print(f"committor diagnostics: mean q(A) = "
              f"{float(aux['mean_q_a']):.4f} (want 0), mean q(B) = "
              f"{float(aux['mean_q_b']):.4f} (want 1), Dirichlet energy "
              f"= {float(aux['dirichlet']):.4g}")
    elif args.loss == "tae":
        # the learned CVs' lag autocorrelations and implied timescales
        from ..train import tica

        sel = _sample(n - args.lag)
        with torch.no_grad():
            r = tica(trained(dev(ds[sel])), trained(dev(ds[sel + args.lag])),
                     lag=args.lag)
        ts = r.timescales()
        print(f"TAE CV lag-{args.lag} autocorrelations (slowest first): "
              + ", ".join(f"{a:.4f}" for a in r.eigenvalues)
              + "; implied timescales (frames): "
              + ", ".join("inf" if not np.isfinite(t) else f"{t:.1f}"
                          for t in ts))
    elif args.loss == "vamp":
        # the learned CVs' lag autocorrelations and implied timescales
        from ..train import vamp2_loss

        sel = _sample(n - args.lag)
        ws = dev(weights[sel]) if weights is not None else None
        with torch.no_grad():
            _, aux = vamp2_loss(
                trained, dev(ds[sel]), dev(ds[sel + args.lag]), weights=ws,
                return_aux=True)
        ac = aux["autocorrelations"].cpu().numpy().astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            ts = np.where((ac > 0) & (ac < 1), -args.lag / np.log(ac),
                          np.inf)
        print(f"VAMP-2 score = {float(aux['vamp2']):.4f}; CV lag-"
              f"{args.lag} autocorrelations (slowest first): "
              + ", ".join(f"{a:.4f}" for a in ac)
              + "; implied timescales (frames): "
              + ", ".join(f"{t:.1f}" for t in ts))
    return 0


def register(sub):
    pt = sub.add_parser("train", help="train a model on a trajectory")
    pt.add_argument("model")
    pt.add_argument("traj", help=".npy trajectory [n, atoms, 3]")
    pt.add_argument("--loss",
                    choices=["mse", "eigenfunction", "autoencoder",
                             "committor", "vamp", "tae"],
                    default="mse")
    pt.add_argument("--lag", type=int, default=10,
                    help="time lag in frames (vamp/tae): pairs (x_t, "
                         "x_{t+lag}) from a CONTIGUOUS trajectory")
    pt.add_argument("--targets", default=None,
                    help=".npy per-frame targets [n, d] (mse)")
    pt.add_argument("--weights", default=None,
                    help=".npy per-frame importance weights [n] "
                         "(eigenfunction/autoencoder/committor; e.g. "
                         "metadynamics frame weights)")
    pt.add_argument("--labels", default=None,
                    help=".npy per-frame basin labels [n] (committor): "
                         "1 = reactant A, 2 = product B, 0 = neither")
    pt.add_argument("--decoder-hidden", type=int, nargs="*", default=None,
                    help="decoder hidden dims (autoencoder; default: "
                         "direct linear map back to feature space)")
    pt.add_argument("--decoder-out", default=None,
                    help="also save the trained decoder (autoencoder)")
    pt.add_argument("--beta", type=float, default=1.0,
                    help="inverse temperature (eigenfunction/committor)")
    pt.add_argument("--alpha", type=float, default=None,
                    help="penalty weight: orthonormality (eigenfunction, "
                         "default 10) or boundary conditions (committor, "
                         "default 100)")
    pt.add_argument("--steps", type=int, default=1000)
    pt.add_argument("--batch-size", type=int, default=1024)
    pt.add_argument("--lr", type=float, default=1e-3)
    pt.add_argument("--optimizer",
                    choices=["adam", "adamw", "sgd", "rmsprop"],
                    default="adam")
    pt.add_argument("--weight-decay", type=float, default=1e-4,
                    help="decoupled weight decay (adamw)")
    pt.add_argument("--momentum", type=float, default=0.9,
                    help="momentum (sgd)")
    pt.add_argument("--lr-schedule",
                    choices=["constant", "cosine", "warmup-cosine",
                             "exponential"],
                    default="constant")
    pt.add_argument("--warmup-steps", type=int, default=100,
                    help="linear warmup length (warmup-cosine)")
    pt.add_argument("--final-lr-scale", type=float, default=0.01,
                    help="lr at the last step as a fraction of --lr "
                         "(cosine/warmup-cosine/exponential)")
    pt.add_argument("--grad-clip", type=float, default=0.0,
                    help="clip gradients to this global norm (0 = off)")
    pt.add_argument("--ensemble", type=int, default=0, metavar="K",
                    help="train a committee of K members (freshly "
                         "re-initialized from one seeded generator); writes "
                         "OUT-stem.member{0..K-1}.npz for the `committee` "
                         "command")
    pt.add_argument("--bagging", action="store_true",
                    help="with --ensemble: each member trains on a "
                         "bootstrap resample of every batch (decorrelates "
                         "members beyond their init)")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--devices", type=int, default=0,
                    help="shard batches over N devices (data-parallel, one "
                         "rank each: the cards; host processes with "
                         "--device cpu)")
    add_device_arg(pt, "train")
    pt.add_argument("--checkpoint-dir", default=None)
    pt.add_argument("--checkpoint-every", type=int, default=0)
    pt.add_argument("--log-every", type=int, default=100)
    pt.add_argument("--out", default="trained.npz")
    pt.set_defaults(fn=cmd_train)
